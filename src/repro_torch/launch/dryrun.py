"""Dry run: every arch's cells at the production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch copml-logreg \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --shape all \\
        --mesh both --execute-ranks 4 --out results/

Each cell models one step at 256 (pod) or 512 (multipod) ranks and runs
one real step at --execute-ranks ranks (0: the model alone); see
launch/copml_dist.py.  The modelled numbers are a model of a mesh this
machine does not have; the executed step's are measured.  --out writes
one JSON a cell.  Every requested cell is reported; a failing cell is
reported and the run goes on, then exits 1.

The LM archs' cells (launch/lm_dryrun.py) take the LM shapes (train_4k,
prefill_32k, decode_32k, and long_500k where the arch is sub-quadratic;
a SKIP line otherwise): a model of one rank of the mesh, and with
--execute-ranks > 0 one SMOKE step of the cell's kind run on the device.
"""

import argparse
import json
import os
import sys
import time

from ..configs import registry
from . import copml_dist, lm_dryrun
from . import mesh as mesh_lib

SHAPES = ("smoke", "train_4k", "prefill_32k", "decode_32k", "long_500k")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir=None,
             execute_ranks: int = 4, device=None) -> dict:
    t0 = time.perf_counter()
    ranks = mesh_lib.production_ranks(multi_pod=multi_pod)
    if arch in registry.LM_ARCH_IDS:
        rec = lm_dryrun.dryrun_cell(arch, shape_name, multi_pod,
                                    execute_ranks=execute_ranks,
                                    device=device)
    elif arch == "copml-logreg":
        rec = copml_dist.dryrun_cell(shape_name, ranks, multi_pod,
                                     execute_ranks=execute_ranks,
                                     device=device)
    else:
        raise ValueError(f"no dry-run cell for arch {arch!r}")
    rec["wall_s"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'multipod' if multi_pod else 'pod'}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=registry.ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=SHAPES + ("all",))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--execute-ranks", type=int, default=4,
                    help="ranks of the one real step a cell runs (0: the "
                         "model alone)")
    ap.add_argument("--device", choices=copml_dist.DEVICES, default=None,
                    help="the executed step's device: the CUDA card (the "
                         "default) or the CPU")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = SHAPES if args.all or args.shape in (None, "all") \
        else (args.shape,)
    meshes = {"pod": (False,), "multipod": (True,),
              "both": (False, True)}[args.mesh]
    failures = []
    for arch in archs:
        arch_shapes = shapes
        if arch in registry.LM_ARCH_IDS and len(shapes) > 1:
            arch_shapes = tuple(lm_dryrun.SHAPES)    # "all": the LM shapes
        for shape in arch_shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, mp, args.out,
                                   args.execute_ranks, args.device)
                    if "skipped" in rec.get("status", ""):
                        print(f"SKIP {arch} x {shape}: {rec['status']}")
                except Exception as e:  # noqa: BLE001 -- report and continue
                    failures.append((arch, shape, mp, repr(e)[:200]))
                    print(f"FAIL {arch} x {shape} multipod={mp}: {e!r}",
                          file=sys.stderr)
    if failures:
        print(f"{len(failures)} failures", file=sys.stderr)
        sys.exit(1)
    print("dry-run: all requested cells compiled")


if __name__ == "__main__":
    main()
