"""The fit() front door: `fit(workload, "copml", engine)`.

This slice carries the copml protocol on the fused-step schedule.  The
"jit" and "eager" engines are the same Python loop here (the step is not
captured as a CUDA graph yet); both names are accepted so calls written
against the JAX package's API run unchanged.  A run uses the CUDA card
unless the caller passes device="cpu"; with no card and no device it
raises.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.protocol import Copml, resolve_device
from . import result as result_mod
from . import workloads as workloads_mod

ENGINES = ("jit", "eager")

_DRIVERS: dict = {}


def driver(wl, device) -> Copml:
    """The cached Copml instance for (workload, device)."""
    key = (wl, str(device))
    if key not in _DRIVERS:
        _DRIVERS[key] = Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                              device=device)
    return _DRIVERS[key]


def fit(workload, protocol: str = "copml", engine: str = "jit", *, key=0,
        iters: int | None = None, subset=None, history: bool = True,
        device=None) -> result_mod.TrainResult:
    """Train `workload` with COPML.

    workload: registry name or a workloads.Workload.
    protocol: "copml" (the only protocol of this slice).
    engine:   "jit" | "eager" (one loop; see the module docstring).
    key:      int seed, or a JAX key's data as a (2,) uint32 array.
    iters:    GD iterations (None = the workload's default).
    subset:   decode subset; None inherits the workload's default, "all"
              or () forces full decode.
    history:  keep the per-step opened model and accuracy curve.
    device:   "cuda" (default when a card is present) or "cpu".
    """
    if protocol != "copml":
        raise ValueError(f"protocol {protocol!r} is not ported yet; "
                         f"this port fits 'copml'")
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: this port runs {ENGINES}")
    dev = resolve_device(device)
    wl = workloads_mod.resolve(workload)
    iters = wl.iters if iters is None else int(iters)
    if subset is None:
        subset = wl.subset
    elif isinstance(subset, str):
        if subset != "all":
            raise ValueError(f"subset must be None, 'all', or client "
                             f"indices; got {subset!r}")
        subset = None
    else:
        subset = tuple(subset) or None

    proto = driver(wl, dev)
    cx, cy = wl.client_data()
    timings: dict = {}
    t0 = time.perf_counter()
    state, w, hist = proto.train(key, cx, cy, iters, subset=subset,
                                 history=history, timings=timings)
    w = w.cpu().numpy()
    hist = None if hist is None else hist.cpu().numpy()
    wall = time.perf_counter() - t0

    x_eval, y_eval = wl.eval_set()
    obj = wl.objective
    acc = None if hist is None else np.asarray(
        [obj.score(w_t, x_eval, y_eval) for w_t in hist])
    return result_mod.TrainResult(
        workload=wl.name, protocol="copml", engine=engine, iters=iters,
        weights=w, wall_time_s=wall, history=hist, accuracy=acc,
        final_accuracy=obj.score(w, x_eval, y_eval),
        per_class_accuracy=obj.per_class_accuracy(w, x_eval, y_eval),
        device=str(dev), timings=timings, state=state)
