"""Coded straggler tolerance: the paper's recovery threshold as a budget.

A COPML gradient round decodes from ANY R = (2r+1)(K+T-1)+1 of N coded
contributions, and Shamir-shared secure aggregation needs only T+1 of N
shares.  `straggler_budget` reports how many clients a configuration can
lose per step at zero recovery cost; `validate_budget` turns that budget
into a hard check that api.fit(..., faults=plan) runs before any compute.

Re-meshing on restart: a checkpoint holds whole logical arrays
(train/checkpoint.py), so it restores onto any mesh; `replan_mesh` picks
the closest valid (data, model) factorization for the surviving device
count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import lagrange, meshutil


def replan_shape(n_devices: int, prefer_model: int = 16) -> tuple:
    """The factorization behind replan_mesh: the largest (data, model) with
    model | prefer_model that divides n_devices (non-power-of-two counts
    fall through to the largest fitting divisor; odd counts end at
    model = 1)."""
    model = prefer_model
    while model > 1 and (n_devices % model or model > n_devices):
        model //= 2
    return n_devices // model, model


def replan_mesh(n_devices: int, prefer_model: int = 16) -> meshutil.Mesh:
    """The largest (data, model) mesh with model | prefer_model that fits."""
    data, model = replan_shape(n_devices, prefer_model)
    return meshutil.make_mesh((data, model), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class StragglerBudget:
    n: int
    recovery_threshold: int

    @property
    def tolerable(self) -> int:
        return self.n - self.recovery_threshold


def straggler_budget(n: int, k: int, t: int, r: int = 1) -> StragglerBudget:
    return StragglerBudget(n, lagrange.recovery_threshold(r, k, t))


def secure_agg_budget(n: int, t: int) -> StragglerBudget:
    """Shamir aggregation: any T+1 of N shares reconstruct."""
    return StragglerBudget(n, t + 1)


class FaultPlanViolation(ValueError):
    """A fault schedule drops below the protocol's recovery threshold.

    Raised by plan validation before any compute happens; the message names
    the first violating step, its availability, and the threshold."""


def plan_headroom(available_counts, threshold: int) -> np.ndarray:
    """Per-step headroom: available contributors minus the recovery
    threshold.  Negative entries are the steps a decode would fail."""
    return np.asarray(available_counts, np.int64) - int(threshold)


def validate_budget(available_counts, threshold: int,
                    what: str = "decode") -> np.ndarray:
    """Reject schedules that ever drop below `threshold` contributors.

    available_counts: per-step number of honest, on-time clients.
    Returns the per-step headroom array on success; raises
    FaultPlanViolation naming the first violating step otherwise."""
    head = plan_headroom(available_counts, threshold)
    bad = np.flatnonzero(head < 0)
    if bad.size:
        s = int(bad[0])
        raise FaultPlanViolation(
            f"fault plan leaves {int(head[s]) + threshold} available "
            f"clients at step {s}, below the {what} recovery threshold "
            f"{threshold} ({bad.size} violating step(s) total)")
    return head
