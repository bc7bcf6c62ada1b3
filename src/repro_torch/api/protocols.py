"""Protocol registry and the fit() front door: `fit(workload, protocol,
engine)`.

Five interchangeable training protocols over the same workloads, the
paper's Section V comparison as a registry, with the JAX package's names:

  copml         Algorithm 1: LCC-coded secret-shared training
                (core/protocol.Copml), on either schedule
                (REPRO_FUSED_STEP, read when a workload's driver is built)
                and under fault plans.
  mpc_baseline  the [BGW88]/[BH08] Appendix-D baselines: every multiply
                is a secure multiplication with degree reduction
                (core/baselines.MpcBaseline).
  float         conventional plaintext GD (the Fig. 4 reference).
  poly_float    plaintext GD with the degree-r polynomial sigmoid.
  secure_agg    clear local gradients, Shamir-coded secure aggregation of
                the exchange (core/secure_agg); fault plans pick each
                round's T+1 share holders.

Engine specs are parsed by api/engine.py as in the JAX package ("jit:4"
raises; a result records the spec's label).  Every protocol runs "jit"
and "eager": for the field protocols they are the same Python loop (no
CUDA graph yet); for float and poly_float "eager" is the float64 trainer
and "jit" the float32 one, as in the JAX package.  copml also runs
"proc[:N]" (launch/runtime: N worker processes over localhost sockets,
with measured communication); the sharded engine is not ported.  A run
uses the CUDA card unless the caller passes device="cpu"; with no card
and no device it raises.  Drivers are cached per (workload, device[,
REPRO_FUSED_STEP]).
"""

from __future__ import annotations

import time

import numpy as np

from ..core import baselines, cost_model, secure_agg
from ..core import objectives as objectives_mod
from ..core.protocol import Copml, fused_mode_from_env, resolve_device
from ..launch import runtime
from ..train import elastic
from . import engine as engine_mod
from . import faults as faults_mod
from . import result as result_mod
from . import workloads as workloads_mod

# engines of the JAX package that this port does not run yet
NOT_PORTED = {"sharded": "the multi-device engine, ROADMAP Queue A item 3"}

PROTOCOLS: dict = {}


def register(protocol: "Protocol") -> "Protocol":
    PROTOCOLS[protocol.name] = protocol
    return protocol


def get(name: str) -> "Protocol":
    if name not in PROTOCOLS:
        known = ", ".join(sorted(PROTOCOLS))
        raise KeyError(f"unknown protocol {name!r}; registered: {known}")
    return PROTOCOLS[name]


def names() -> tuple:
    return tuple(sorted(PROTOCOLS))


def fit(workload, protocol: str = "copml", engine: str = "jit", *, key=0,
        iters: int | None = None, subset=None, history: bool = True,
        faults=None, device=None) -> result_mod.TrainResult:
    """Train `workload` with `protocol` on `engine`; the one front door.

    workload: registry name or a workloads.Workload.
    protocol: a name in PROTOCOLS.
    engine:   "jit" | "eager" | "proc[:N]" (copml) | an api.EngineSpec
              (api.parse_engine).
    key:      int seed, or a JAX key's data as a (2,) uint32 array.
    iters:    GD iterations (None = the workload's default).
    subset:   decode subset (copml, secure_agg); None inherits the
              workload's default on those protocols, "all" or () forces
              full decode.
    history:  keep the per-step opened model and accuracy curve.
    faults:   a faults.FaultPlan (per-step straggler / dropout / adversary
              schedule), validated against the protocol's threshold before
              any compute (FaultPlanViolation).  Excludes `subset`.
    device:   "cuda" (default when a card is present) or "cpu".
    """
    return get(protocol).fit(workload, engine, key=key, iters=iters,
                             subset=subset, history=history, faults=faults,
                             device=device)


class Protocol:
    """One training protocol behind the common fit() interface.

    Subclasses implement `_run` and optionally `cost`; the base class owns
    argument checks, timing and TrainResult assembly."""

    name: str = "?"
    engines: tuple = ("eager", "jit")
    supports_subset: bool = False    # straggler decode subsets
    supports_faults: bool = False    # per-step FaultPlan schedules

    def fit(self, workload, engine="jit", *, key=0, iters=None, subset=None,
            history=True, faults=None, device=None) -> result_mod.TrainResult:
        spec = engine_mod.parse(engine)
        if spec.kind not in self.engines:
            later = f"; the {spec.kind} engine is not ported yet " \
                f"({NOT_PORTED[spec.kind]})" if spec.kind in NOT_PORTED \
                else ""
            raise ValueError(f"protocol {self.name!r} supports engines "
                             f"{self.engines}, not {spec.label!r}{later}")
        dev = resolve_device(device)
        wl = workloads_mod.resolve(workload)
        iters = wl.iters if iters is None else int(iters)
        if faults is not None:
            if subset is not None:
                raise ValueError(
                    "faults= and subset= are mutually exclusive: the plan "
                    "chooses each step's decode subset")
            plan = self._resolve_plan(wl, iters, faults)
        else:
            plan = None
            if subset is None:
                # the workload default only applies where it means something
                subset = wl.subset if self.supports_subset else None
            elif isinstance(subset, str):
                if subset != "all":
                    raise ValueError(f"subset must be None, 'all', or an "
                                     f"iterable of client indices; got "
                                     f"{subset!r}")
                subset = None                     # force full decode
            else:
                subset = tuple(subset) or None    # () also means full decode
            if subset is not None and not self.supports_subset:
                raise ValueError(
                    f"protocol {self.name!r} has no straggler-subset "
                    f"decoding; drop the subset argument")

        timings: dict = {}
        t0 = time.perf_counter()
        out = self._run(wl, spec, key, iters, subset, history, plan, dev,
                        timings)
        # engines that MEASURE their communication (proc) return a 4th
        # element; the in-process engines keep the 3-tuple contract
        if len(out) == 4:
            w, hist, state, measured = out
        else:
            w, hist, state = out
            measured = None
        w = w.cpu().numpy()
        hist = None if hist is None else hist.cpu().numpy()
        wall = time.perf_counter() - t0

        x_eval, y_eval = wl.eval_set()
        obj = wl.objective
        acc = None if hist is None else np.asarray(
            [obj.score(w_t, x_eval, y_eval) for w_t in hist])
        return result_mod.TrainResult(
            workload=wl.name, protocol=self.name, engine=spec.label,
            iters=iters,
            weights=w, wall_time_s=wall, history=hist, accuracy=acc,
            final_accuracy=obj.score(w, x_eval, y_eval),
            per_class_accuracy=obj.per_class_accuracy(w, x_eval, y_eval),
            cost=self.cost(wl, iters), device=str(dev), timings=timings,
            state=state,
            availability=None if plan is None else plan.available.copy(),
            measured_comm=measured)

    def _resolve_plan(self, wl, iters: int, faults) -> faults_mod.FaultPlan:
        """Check a FaultPlan against this protocol and workload, cut it to
        the run length and run the threshold check, all before any
        compute."""
        if not self.supports_faults:
            raise ValueError(
                f"protocol {self.name!r} has no fault injection; drop the "
                f"faults argument")
        if not isinstance(faults, faults_mod.FaultPlan):
            raise TypeError(f"faults must be a FaultPlan, got "
                            f"{type(faults).__name__}")
        if faults.n_clients != wl.n_clients:
            raise ValueError(
                f"plan covers {faults.n_clients} clients; workload "
                f"{wl.name!r} has {wl.n_clients}")
        if faults.iters < iters:
            raise ValueError(
                f"plan covers {faults.iters} steps; the run needs {iters}")
        plan = faults.slice(iters)
        self._validate_plan(wl, plan)        # raises FaultPlanViolation
        return plan

    def fault_threshold(self, wl) -> int:
        """The per-step availability floor a FaultPlan must keep for this
        protocol on `wl`."""
        raise NotImplementedError            # supports_faults protocols only

    def _validate_plan(self, wl, plan: faults_mod.FaultPlan):
        raise NotImplementedError            # supports_faults protocols only

    def _run(self, wl, spec, key, iters, subset, history, plan, device,
             timings):
        """-> (weights, history-or-None, protocol-native state[, measured
        communication]); weights and history are tensors.  `spec` is the
        parsed EngineSpec; `timings` receives setup_s and iters_s."""
        raise NotImplementedError

    def cost(self, wl, iters: int) -> dict | None:
        """Modeled per-client comm/comp/enc on the paper's WAN params."""
        return None

    def _cost_workload(self, wl, iters: int) -> cost_model.Workload:
        return cost_model.Workload(m=wl.m, d=wl.d, n=wl.n_clients,
                                   k=wl.cfg.k, t=wl.cfg.t, iters=iters,
                                   r=wl.cfg.r, c=wl.objective.n_outputs)


# ------------------------------------------------------------------ copml


def run_copml_engine(proto: Copml, spec, key, client_xs, client_ys,
                     iters: int, subset=None, history: bool = False,
                     step_subsets=None, adversaries=None,
                     timings: dict | None = None) -> tuple:
    """The one dispatch from an EngineSpec to a Copml engine.

    "eager" and "jit" both run Copml.train (the same Python loop here);
    step_subsets/adversaries carry a FaultPlan's per-step decode subsets
    and corruption mask.  Returns (state, weights, history-or-None).
    The proc engine, which also returns its measured communication, is
    launch.runtime.run_copml_proc (api.fit calls it); the sharded engine
    is not ported."""
    spec = engine_mod.parse(spec)
    if spec.kind in NOT_PORTED:
        raise ValueError(f"the {spec.kind} engine is not ported yet "
                         f"({NOT_PORTED[spec.kind]})")
    if spec.kind not in ("eager", "jit"):
        raise ValueError(f"run_copml_engine runs the eager and jit engines, "
                         f"not {spec.label!r}; the proc engine is "
                         f"launch.runtime.run_copml_proc")
    return proto.train(key, client_xs, client_ys, iters, subset=subset,
                       history=history, timings=timings,
                       step_subsets=step_subsets, adversaries=adversaries)


class CopmlProtocol(Protocol):
    name = "copml"
    engines = ("eager", "jit", "proc")
    supports_subset = True           # decode from any R of N clients
    supports_faults = True           # per-step FaultPlan schedules

    def __init__(self):
        self._drivers: dict = {}

    def driver(self, wl, device) -> Copml:
        """The cached Copml for (workload, device, REPRO_FUSED_STEP):
        flipping the env var between fits selects the other schedule."""
        key = (wl, str(device), fused_mode_from_env())
        if key not in self._drivers:
            self._drivers[key] = Copml(wl.cfg, wl.m, wl.d,
                                       objective=wl.objective, device=device)
        return self._drivers[key]

    def fault_threshold(self, wl) -> int:
        """R = (2r+1)(K+T-1)+1 honest on-time clients per step."""
        return elastic.straggler_budget(wl.n_clients, wl.cfg.k, wl.cfg.t,
                                        wl.cfg.r).recovery_threshold

    def _validate_plan(self, wl, plan):
        plan.validate(self.fault_threshold(wl), "COPML decode")

    def _run(self, wl, spec, key, iters, subset, history, plan, device,
             timings):
        proto = self.driver(wl, device)
        cx, cy = wl.client_data()
        if spec.kind == "proc":
            if plan is not None:
                raise ValueError(
                    "the proc engine has no FaultPlan replay: stragglers "
                    "emerge from real socket timing -- inject latency / "
                    "deadlines via EngineSpec('proc', net=NetConfig(...)) "
                    "instead")
            state, w, hist, measured = runtime.run_copml_proc(
                proto, key, cx, cy, iters, procs=spec.devices,
                net_cfg=spec.net, subset=subset, history=history,
                timings=timings)
            return w, hist, state, measured
        fault_kw = {}
        if plan is not None:
            fault_kw = dict(
                step_subsets=plan.subsets(self.fault_threshold(wl)),
                adversaries=plan.adversary if plan.has_adversaries else None)
        state, w, hist = run_copml_engine(proto, spec, key, cx, cy, iters,
                                          subset=subset, history=history,
                                          timings=timings, **fault_kw)
        return w, hist, state

    def cost(self, wl, iters):
        return cost_model.copml_costs(self._cost_workload(wl, iters))


class MpcBaselineProtocol(Protocol):
    name = "mpc_baseline"
    scheme = "bh08"
    groups = 3

    def __init__(self):
        self._drivers: dict = {}

    def driver(self, wl, device) -> baselines.MpcBaseline:
        key = (wl, str(device))
        if key not in self._drivers:
            self._drivers[key] = baselines.MpcBaseline(
                wl.cfg, wl.m, wl.d, groups=self.groups, scheme=self.scheme,
                objective=wl.objective, device=device)
        return self._drivers[key]

    def _run(self, wl, spec, key, iters, subset, history, plan, device,
             timings):
        mb = self.driver(wl, device)
        x, y, _, _ = wl.data()
        if spec.kind == "jit":
            out = mb.train_scan(key, x, y, iters, history=history,
                                timings=timings)
            return out[1], (out[2] if history else None), out[0]
        rows, cb = baselines.history_recorder(history)
        state, w = mb.train(key, x, y, iters, callback=cb, timings=timings)
        return w, baselines.stacked(rows, w), state

    def cost(self, wl, iters):
        return cost_model.mpc_baseline_costs(
            self._cost_workload(wl, iters), scheme=self.scheme,
            groups=self.groups)


class FloatProtocol(Protocol):
    name = "float"
    poly = False        # PolyFloatProtocol flips this: same float engine,
    #                     ghat's polynomial instead of the exact activation

    def _run(self, wl, spec, key, iters, subset, history, plan, device,
             timings):
        x, y, _, _ = wl.data()
        obj, eta = wl.objective, wl.cfg.eta
        r, bound = wl.cfg.r, wl.cfg.sigmoid_bound
        kw = dict(device=device, timings=timings)
        if spec.kind == "jit":
            if not isinstance(obj, objectives_mod.BinaryLogistic):
                w, hist = baselines.float_objective_scan(
                    obj, x, y, eta, iters, history=history, poly=self.poly,
                    r=r, bound=bound, **kw)
            elif self.poly:
                w, hist = baselines.float_poly_logreg_scan(
                    x, y, eta, iters, r=r, bound=bound, history=history,
                    **kw)
            else:
                w, hist = baselines.float_logreg_scan(x, y, eta, iters,
                                                      history=history, **kw)
            return w, hist, None
        rows, cb = baselines.history_recorder(history)
        if not isinstance(obj, objectives_mod.BinaryLogistic):
            w = baselines.float_objective_train(
                obj, x, y, eta, iters, callback=cb, poly=self.poly, r=r,
                bound=bound, **kw)
        elif self.poly:
            w = baselines.float_poly_logreg(x, y, eta, iters, r=r,
                                            bound=bound, callback=cb, **kw)
        else:
            w = baselines.float_logreg(x, y, eta, iters, callback=cb, **kw)
        return w, baselines.stacked(rows, w), None


class PolyFloatProtocol(FloatProtocol):
    name = "poly_float"
    poly = True


class SecureAggProtocol(Protocol):
    name = "secure_agg"
    supports_subset = True           # reconstruct from any T+1 holders
    supports_faults = True           # per-step T+1-of-N share selection

    def agg_config(self, wl) -> secure_agg.SecureAggConfig:
        """Privacy threshold T from the workload's COPML parameterization;
        lq/clip at the module defaults (validated against the field)."""
        return secure_agg.SecureAggConfig(n_clients=wl.n_clients, t=wl.cfg.t)

    def _validate_plan(self, wl, plan):
        """Any T+1 holders' shares reconstruct; the plan picks them.  With
        no redundancy on the owner side (every gradient is summed once), a
        corrupted contribution cannot be excluded, so adversarial plans
        are rejected."""
        if plan.has_adversaries:
            raise elastic.FaultPlanViolation(
                "secure_agg tolerates straggling/dropped share holders, "
                "not adversarially corrupted contributions (no decode "
                "redundancy over gradient owners); use the copml protocol "
                "for adversary schedules")
        plan.validate(self.fault_threshold(wl), "secure_agg share")

    def fault_threshold(self, wl) -> int:
        """T+1 share holders per step (Shamir reconstruction)."""
        return elastic.secure_agg_budget(wl.n_clients,
                                         wl.cfg.t).recovery_threshold

    def _run(self, wl, spec, key, iters, subset, history, plan, device,
             timings):
        cx, cy = wl.client_data()
        cfg = self.agg_config(wl)
        kw = dict(subset=subset, objective=wl.objective, device=device,
                  timings=timings,
                  step_subsets=None if plan is None else
                  plan.subsets(cfg.t + 1))
        if spec.kind == "jit":
            w, hist = secure_agg.secure_logreg_scan(
                key, cx, cy, cfg, wl.cfg.eta, iters, history=history, **kw)
            return w, hist, cfg
        rows, cb = baselines.history_recorder(history)
        w = secure_agg.secure_logreg(key, cx, cy, cfg, wl.cfg.eta, iters,
                                     callback=cb, **kw)
        return w, baselines.stacked(rows, w), cfg


register(CopmlProtocol())
register(MpcBaselineProtocol())
register(FloatProtocol())
register(PolyFloatProtocol())
register(SecureAggProtocol())


def driver(wl, device) -> Copml:
    """The copml protocol's cached driver (see CopmlProtocol.driver)."""
    return PROTOCOLS["copml"].driver(wl, device)


def fault_threshold(wl) -> int:
    """R = (2r+1)(K+T-1)+1: the honest, on-time clients a FaultPlan must
    keep at every step of a copml fit on `wl`."""
    return PROTOCOLS["copml"].fault_threshold(wl)
