"""repro_torch.api -- the port's front door.

    from repro_torch import api
    res = api.fit("cifar10_case2", "copml", "jit", iters=5)   # on the card
    res = api.fit("smoke", "copml", "jit", device="cpu")      # plain torch
    plan = api.FaultPlan.from_schedule(13, 4, stragglers={1: (0,)})
    res = api.fit("smoke_straggler", iters=4, faults=plan)    # churn
    res = api.fit("smoke", "mpc_baseline", "jit", iters=5)    # or "float",
    #                                 "poly_float", "secure_agg"
    res = api.fit("cifar10_case2", "copml", "proc:4", iters=5)
    res.measured_comm              # wire bytes, frames, seconds by phase
    srv = api.serve("smoke", res, "jit")     # score from re-shared shares
    preds, stats = srv.serve(queries)

Same workload and protocol names, and the same TrainResult schema, as the
JAX package's api.
"""

from ..core.objectives import (OBJECTIVES, SecureObjective,
                               multiclass_logistic)
from ..core.objectives import get as get_objective
from ..core.objectives import names as objective_names
from ..core.objectives import register as register_objective
from .engine import (EAGER, ENGINES, JIT, PROC, SHARDED, EngineKind,
                     EngineSpec, NetConfig)
from .engine import names as engine_names
from .engine import parse as parse_engine
from .engine import register_kind as register_engine_kind
from .faults import FaultPlan, FaultPlanViolation
from .protocols import (PROTOCOLS, Protocol, fault_threshold, fit,
                        run_copml_engine)
from .protocols import names as protocol_names
from .protocols import register as register_protocol
from .result import TrainResult, accuracy_curve, accuracy_of
from .serving import SERVE_ENGINES, serve
from .workloads import WORKLOADS, Workload
from .workloads import get as get_workload
from .workloads import names as workload_names
from .workloads import register as register_workload

__all__ = [
    "EAGER", "ENGINES", "JIT", "OBJECTIVES", "PROC", "PROTOCOLS",
    "SERVE_ENGINES", "SHARDED", "EngineKind", "EngineSpec", "FaultPlan",
    "FaultPlanViolation", "NetConfig", "Protocol", "SecureObjective",
    "TrainResult", "WORKLOADS", "Workload", "accuracy_curve", "accuracy_of",
    "engine_names", "fault_threshold", "fit", "get_objective",
    "get_workload", "multiclass_logistic", "objective_names",
    "parse_engine", "protocol_names", "register_engine_kind",
    "register_objective", "register_protocol", "register_workload",
    "run_copml_engine", "serve", "workload_names",
]
