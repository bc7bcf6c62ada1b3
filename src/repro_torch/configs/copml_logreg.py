"""The paper's own workload as a selectable arch: COPML secure logistic
regression.  Shapes mirror the paper's datasets (Section V-A):

  cifar10  : (m, d) = (9019, 3073)
  gisette  : (m, d) = (6000, 5000)
  scaled   : a 64x larger synthetic workload exercising pod-scale K/T

and, beside them, CIFAR-10's own ten-class shape (Krizhevsky 2009: 50,000
training images of 3,072 features plus the bias column) as ten
one-vs-rest columns of one (d, 10) model at the paper's N = 50, Case 2.

This module is the source of truth for the PAPER-SCALE shapes only; the
runnable workload registry (these entries plus reduced-scale ones with
eval splits, data builders attached) lives in api/workloads.py and is
what api.fit consumes.
"""

import dataclasses

from ..core import objectives
from ..core.protocol import CopmlConfig


@dataclasses.dataclass(frozen=True)
class CopmlWorkload:
    name: str
    m: int
    d: int
    cfg: CopmlConfig
    # the model family: a class attribute and not a field, so that a binary
    # workload's fields stay the JAX package's
    objective = objectives.BINARY_LOGISTIC


@dataclasses.dataclass(frozen=True)
class CopmlClassesWorkload(CopmlWorkload):
    """C one-vs-rest logistic columns of one (d, C) model."""
    objective: objectives.SecureObjective = objectives.get("ovr10")


def _cfg(n, k, t):
    return CopmlConfig(n_clients=n, k=k, t=t, eta=1.0)


# paper-scale (N=50, Case 1 / Case 2 from Section V)
CIFAR10_CASE1 = CopmlWorkload("cifar10_case1", 9019, 3073, _cfg(50, 16, 1))
CIFAR10_CASE2 = CopmlWorkload("cifar10_case2", 9019, 3073, _cfg(50, 10, 7))
GISETTE_CASE1 = CopmlWorkload("gisette_case1", 6000, 5000, _cfg(50, 16, 1))
# CIFAR-10's ten classes at its published m; eta = 1 does not fit the field
# at this m, so api/workloads scales it with m (eta = m / 4096, k1 = 23).
# TruncPr's window k2 = 25, the field's most: at the default 24 the ten
# columns' first updates (|X^T(ghat - y)| up to ~700) leave it and the
# open wraps p
CIFAR10_OVR10_CASE2 = CopmlClassesWorkload(
    "cifar10_ovr10_case2", 50000, 3073,
    CopmlConfig(n_clients=50, k=10, t=7, eta=1.0, k2=25))
# pod-scale (N=512 clients = one client per device on the multi-pod mesh)
POD512 = CopmlWorkload("pod512", 262144, 4096, _cfg(512, 128, 43))

WORKLOADS = {w.name: w for w in
             (CIFAR10_CASE1, CIFAR10_CASE2, GISETTE_CASE1,
              CIFAR10_OVR10_CASE2, POD512)}

CONFIG = CIFAR10_CASE2     # default
SMOKE = CopmlWorkload("smoke", 96, 12, _cfg(13, 4, 1))
