"""The paper's Section V comparison as a registry sweep.

Runs the same workload through every registered protocol (COPML, the
[BH08]-style MPC baseline, plaintext float, polynomial-sigmoid float, and
secure aggregation) on the jit engine, and prints one TrainResult row
each -- the Table-I/Fig-4 comparison reduced to formatting.

    PYTHONPATH=src python -m repro_torch.examples.protocol_matrix
    PYTHONPATH=src python -m repro_torch.examples.protocol_matrix --device cpu
"""

import argparse

from repro_torch import api


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for plain torch (default: the CUDA card)")
    args = ap.parse_args(argv)

    wl, iters = "smoke", 10
    print(f"workload {wl!r}, {iters} GD iterations, engine jit\n")
    print(f"{'protocol':14s} {'accuracy':>8s} {'wall_s':>8s} "
          f"{'modeled comm_s':>14s}")
    rows = {}
    for name in api.protocol_names():
        res = rows[name] = api.fit(wl, name, "jit", key=0, iters=iters,
                                   device=args.device)
        comm = "-" if res.cost is None else f"{res.cost['comm_s']:.1f}"
        print(f"{name:14s} {res.final_accuracy:8.3f} "
              f"{res.wall_time_s:8.2f} {comm:>14s}")
    print("\n(modeled comm prices the paper's 40 Mbps WAN; float protocols "
          "exchange nothing)")
    return rows


if __name__ == "__main__":
    main()
