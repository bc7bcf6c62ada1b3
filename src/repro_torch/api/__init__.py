"""repro_torch.api -- the port's front door.

    from repro_torch import api
    res = api.fit("cifar10_case2", "copml", "jit", iters=5)   # on the card
    res = api.fit("smoke", "copml", "jit", device="cpu")      # plain torch
    plan = api.FaultPlan.from_schedule(13, 4, stragglers={1: (0,)})
    res = api.fit("smoke_straggler", iters=4, faults=plan)    # churn

Same workload names and TrainResult schema as the JAX package's api.
"""

from ..core.objectives import (OBJECTIVES, SecureObjective,
                               multiclass_logistic)
from ..core.objectives import get as get_objective
from .faults import FaultPlan, FaultPlanViolation
from .protocols import ENGINES, fault_threshold, fit
from .result import TrainResult, accuracy_curve, accuracy_of
from .workloads import WORKLOADS, Workload
from .workloads import get as get_workload
from .workloads import names as workload_names
from .workloads import register as register_workload

__all__ = [
    "ENGINES", "OBJECTIVES", "FaultPlan", "FaultPlanViolation",
    "SecureObjective", "TrainResult", "WORKLOADS", "Workload",
    "accuracy_curve", "accuracy_of", "fault_threshold", "fit",
    "get_objective", "get_workload", "multiclass_logistic",
    "register_workload", "workload_names",
]
