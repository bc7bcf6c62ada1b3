"""The paper's own workload as a selectable arch: COPML secure logistic
regression.  Shapes mirror the paper's datasets (Section V-A):

  cifar10  : (m, d) = (9019, 3073)
  gisette  : (m, d) = (6000, 5000)
  scaled   : a 64x larger synthetic workload exercising pod-scale K/T

This module is the source of truth for the PAPER-SCALE shapes only; the
runnable workload registry (these entries plus reduced-scale ones with
eval splits, data builders attached) lives in api/workloads.py and is
what api.fit consumes.
"""

import dataclasses

from ..core.protocol import CopmlConfig


@dataclasses.dataclass(frozen=True)
class CopmlWorkload:
    name: str
    m: int
    d: int
    cfg: CopmlConfig


def _cfg(n, k, t):
    return CopmlConfig(n_clients=n, k=k, t=t, eta=1.0)


# paper-scale (N=50, Case 1 / Case 2 from Section V)
CIFAR10_CASE1 = CopmlWorkload("cifar10_case1", 9019, 3073, _cfg(50, 16, 1))
CIFAR10_CASE2 = CopmlWorkload("cifar10_case2", 9019, 3073, _cfg(50, 10, 7))
GISETTE_CASE1 = CopmlWorkload("gisette_case1", 6000, 5000, _cfg(50, 16, 1))
# pod-scale (N=512 clients = one client per device on the multi-pod mesh)
POD512 = CopmlWorkload("pod512", 262144, 4096, _cfg(512, 128, 43))

WORKLOADS = {w.name: w for w in
             (CIFAR10_CASE1, CIFAR10_CASE2, GISETTE_CASE1, POD512)}

CONFIG = CIFAR10_CASE2     # default
SMOKE = CopmlWorkload("smoke", 96, 12, _cfg(13, 4, 1))
