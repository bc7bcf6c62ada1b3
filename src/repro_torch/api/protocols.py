"""The fit() front door: `fit(workload, "copml", engine)`.

This port carries the copml protocol on both schedules (REPRO_FUSED_STEP,
read when a workload's driver is built) and replays fault plans on either.
The "jit" and "eager" engines are the same Python loop here (the step is
not captured as a CUDA graph yet); both names are accepted so calls written
against the JAX package's API run unchanged.  A run uses the CUDA card
unless the caller passes device="cpu"; with no card and no device it
raises.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.protocol import Copml, fused_mode_from_env, resolve_device
from ..train import elastic
from . import faults as faults_mod
from . import result as result_mod
from . import workloads as workloads_mod

ENGINES = ("jit", "eager")

_DRIVERS: dict = {}


def driver(wl, device) -> Copml:
    """The cached Copml instance for (workload, device, REPRO_FUSED_STEP):
    flipping the env var between fits selects the other schedule."""
    key = (wl, str(device), fused_mode_from_env())
    if key not in _DRIVERS:
        _DRIVERS[key] = Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                              device=device)
    return _DRIVERS[key]


def fault_threshold(wl) -> int:
    """R = (2r+1)(K+T-1)+1: the honest, on-time clients a FaultPlan must
    keep at every step of a copml fit on `wl`."""
    return elastic.straggler_budget(wl.n_clients, wl.cfg.k, wl.cfg.t,
                                    wl.cfg.r).recovery_threshold


def _resolve_plan(wl, iters: int, faults) -> faults_mod.FaultPlan:
    """Check a FaultPlan against the workload, cut it to the run length and
    run the recovery-threshold check, all before any compute."""
    if not isinstance(faults, faults_mod.FaultPlan):
        raise TypeError(f"faults must be a FaultPlan, got "
                        f"{type(faults).__name__}")
    if faults.n_clients != wl.n_clients:
        raise ValueError(f"plan covers {faults.n_clients} clients; workload "
                         f"{wl.name!r} has {wl.n_clients}")
    if faults.iters < iters:
        raise ValueError(
            f"plan covers {faults.iters} steps; the run needs {iters}")
    plan = faults.slice(iters)
    plan.validate(fault_threshold(wl), "COPML decode")
    return plan


def fit(workload, protocol: str = "copml", engine: str = "jit", *, key=0,
        iters: int | None = None, subset=None, history: bool = True,
        faults=None, device=None) -> result_mod.TrainResult:
    """Train `workload` with COPML.

    workload: registry name or a workloads.Workload.
    protocol: "copml" (the only protocol ported so far).
    engine:   "jit" | "eager" (one loop; see the module docstring).
    key:      int seed, or a JAX key's data as a (2,) uint32 array.
    iters:    GD iterations (None = the workload's default).
    subset:   decode subset; None inherits the workload's default, "all"
              or () forces full decode.
    history:  keep the per-step opened model and accuracy curve.
    faults:   a faults.FaultPlan (per-step straggler / dropout / adversary
              schedule), validated against the recovery threshold before
              any compute (FaultPlanViolation).  Excludes `subset`.
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
    plan = None
    if faults is not None:
        if subset is not None:
            raise ValueError("faults= and subset= are mutually exclusive: "
                             "the plan chooses each step's decode subset")
        plan = _resolve_plan(wl, iters, faults)
    elif subset is None:
        subset = wl.subset
    elif isinstance(subset, str):
        if subset != "all":
            raise ValueError(f"subset must be None, 'all', or client "
                             f"indices; got {subset!r}")
        subset = None
    else:
        subset = tuple(subset) or None

    fault_kw = {}
    if plan is not None:
        fault_kw = dict(
            step_subsets=plan.subsets(fault_threshold(wl)),
            adversaries=plan.adversary if plan.has_adversaries else None)
    proto = driver(wl, dev)
    cx, cy = wl.client_data()
    timings: dict = {}
    t0 = time.perf_counter()
    state, w, hist = proto.train(key, cx, cy, iters, subset=subset,
                                 history=history, timings=timings,
                                 **fault_kw)
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
        device=str(dev), timings=timings, state=state,
        availability=None if plan is None else plan.available.copy())
