"""Fault-injection plans: per-step straggler / dropout / adversary schedules.

COPML decodes a gradient round from ANY R = (2r+1)(K+T-1)+1 of the N coded
contributions.  A `FaultPlan` turns that from a single static `subset=`
into a schedule: for every training step it says which clients straggle
(miss the round), which have permanently dropped out, and which contribute
adversarially corrupted values.  `api.fit(workload, "copml", engine,
faults=plan)` replays it: the plan is compiled once into (iters, R)
decode-index / decode-row tensors on the run's device (one exact Lagrange
row per distinct subset) plus the (iters, N) adversary mask, and each step
takes its row.

Semantics (enforced in validate()):

* a straggling client's contribution simply misses that round's decode;
* a dropout is a straggler for every remaining step;
* an adversary's contribution is actually corrupted (offset by
  core.protocol.ADV_OFFSET, large enough to survive TruncPr's rescale)
  and excluded from the decode subset;
* decoding from any valid subset yields the identical field element, so a
  faulty run is bit-exact with the fault-free run of the same key.

Validation (train/elastic.py budgets, promoted to hard errors): a plan
whose per-step availability ever drops below the protocol's recovery
threshold raises `FaultPlanViolation` before any compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..train.elastic import (FaultPlanViolation, plan_headroom,
                             validate_budget)

__all__ = ["FaultPlan", "FaultPlanViolation", "plan_headroom",
           "validate_budget"]


def _normalize_schedule(sched, iters: int, n: int, what: str) -> dict:
    """{step: iterable-of-client-ids} with bounds checks."""
    out = {}
    for step, clients in (sched or {}).items():
        step = int(step)
        if not 0 <= step < iters:
            raise ValueError(f"{what} schedule step {step} outside "
                             f"[0, {iters})")
        ids = tuple(int(c) for c in clients)
        for c in ids:
            if not 0 <= c < n:
                raise ValueError(f"{what} schedule names client {c} "
                                 f"outside [0, {n})")
        out[step] = ids
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class FaultPlan:
    """A per-step fault schedule over N clients and `iters` training steps.

    available: (iters, N) bool -- True where the client contributes an
               honest result on time (eligible for that step's decode).
    adversary: (iters, N) bool -- True where the client contributes a
               CORRUPTED result (never eligible for decode).  Disjoint
               from `available` by construction.
    """
    n_clients: int
    iters: int
    available: np.ndarray
    adversary: np.ndarray

    def __post_init__(self):
        # copy: freezing an np.asarray view would make the CALLER's array
        # read-only as a side effect
        avail = np.array(self.available, dtype=bool, copy=True)
        adv = np.array(self.adversary, dtype=bool, copy=True)
        shape = (self.iters, self.n_clients)
        if avail.shape != shape or adv.shape != shape:
            raise ValueError(f"plan masks must be {shape}; got "
                             f"{avail.shape} / {adv.shape}")
        if (avail & adv).any():
            raise ValueError("a client cannot be both available and "
                             "adversarial in the same step")
        avail.flags.writeable = False
        adv.flags.writeable = False
        object.__setattr__(self, "available", avail)
        object.__setattr__(self, "adversary", adv)

    # ------------------------------------------------------------ builders

    @classmethod
    def fault_free(cls, n_clients: int, iters: int) -> "FaultPlan":
        return cls(n_clients, iters,
                   np.ones((iters, n_clients), bool),
                   np.zeros((iters, n_clients), bool))

    @classmethod
    def from_schedule(cls, n_clients: int, iters: int, *,
                      stragglers=None, dropouts=None,
                      adversaries=None) -> "FaultPlan":
        """Build a plan from explicit step->clients maps.

        stragglers[s]:  clients missing step s only.
        dropouts[s]:    clients gone from step s ONWARD (permanent).
        adversaries[s]: clients corrupted from step s ONWARD (permanent --
                        a compromised client stays compromised).
        """
        avail = np.ones((iters, n_clients), bool)
        adv = np.zeros((iters, n_clients), bool)
        for s, ids in _normalize_schedule(stragglers, iters, n_clients,
                                          "straggler").items():
            avail[s, list(ids)] = False
        for s, ids in _normalize_schedule(dropouts, iters, n_clients,
                                          "dropout").items():
            avail[s:, list(ids)] = False
        for s, ids in _normalize_schedule(adversaries, iters, n_clients,
                                          "adversary").items():
            avail[s:, list(ids)] = False
            adv[s:, list(ids)] = True
        return cls(n_clients, iters, avail, adv)

    @classmethod
    def random(cls, n_clients: int, iters: int, *, seed: int = 0,
               straggle_p: float = 0.0, n_dropouts: int = 0,
               n_adversaries: int = 0,
               min_available: int | None = None) -> "FaultPlan":
        """Seeded churn: i.i.d. per-(step, client) straggling at
        `straggle_p`, plus `n_dropouts` clients dying and `n_adversaries`
        turning corrupt at random steps.  With `min_available` set, steps
        that would fall below it are repaired by reviving the lowest-index
        stragglers (dropouts and adversaries are never revived), so seeded
        plans stay above a known recovery threshold by construction."""
        rng = np.random.default_rng(seed)
        avail = rng.random((iters, n_clients)) >= straggle_p
        adv = np.zeros((iters, n_clients), bool)
        if n_dropouts + n_adversaries > n_clients:
            raise ValueError("more dropouts+adversaries than clients")
        perm = rng.permutation(n_clients)
        dropped = perm[:n_dropouts]
        corrupt = perm[n_dropouts:n_dropouts + n_adversaries]
        # non-revivable only from each client's fault-start step ONWARD --
        # before its dropout a client is an ordinary straggler
        permanent = np.zeros((iters, n_clients), bool)
        for c in dropped:
            s = int(rng.integers(0, iters))
            avail[s:, c] = False
            permanent[s:, c] = True
        for c in corrupt:
            s = int(rng.integers(0, iters))
            avail[s:, c] = False
            adv[s:, c] = True
            permanent[s:, c] = True
        if min_available is not None:
            for s in range(iters):
                short = min_available - int(avail[s].sum())
                if short > 0:
                    revivable = np.flatnonzero(~avail[s] & ~permanent[s])
                    if revivable.size < short:
                        raise FaultPlanViolation(
                            f"cannot repair step {s} to {min_available} "
                            f"available clients: only {revivable.size} "
                            f"revivable stragglers")
                    avail[s, revivable[:short]] = True
        return cls(n_clients, iters, avail, adv)

    # ------------------------------------------------------------- queries

    @property
    def available_counts(self) -> np.ndarray:
        """(iters,) honest on-time contributors per step."""
        return self.available.sum(axis=1).astype(np.int64)

    @property
    def has_adversaries(self) -> bool:
        return bool(self.adversary.any())

    @property
    def is_fault_free(self) -> bool:
        return bool(self.available.all()) and not self.has_adversaries

    def headroom(self, threshold: int) -> np.ndarray:
        """Per-step spare contributors above `threshold` (may be negative)."""
        return plan_headroom(self.available_counts, threshold)

    def validate(self, threshold: int, what: str = "decode") -> np.ndarray:
        """elastic.validate_budget on this plan's availability; raises
        FaultPlanViolation (before any compute) or returns the headroom."""
        return validate_budget(self.available_counts, threshold, what)

    def subsets(self, r: int) -> tuple:
        """Per-step decode subsets: the first `r` available client indices
        each step (deterministic, so every engine replays the same plan
        identically).  Requires a validated plan (>= r available)."""
        out = []
        for s in range(self.iters):
            ids = np.flatnonzero(self.available[s])
            if ids.size < r:
                raise FaultPlanViolation(
                    f"step {s} has {ids.size} available clients < {r}")
            out.append(tuple(int(i) for i in ids[:r]))
        return tuple(out)

    def slice(self, iters: int) -> "FaultPlan":
        """The plan's first `iters` steps (fit may run fewer steps than the
        plan covers; it may never run more)."""
        if iters > self.iters:
            raise ValueError(f"plan covers {self.iters} steps; cannot "
                             f"slice to {iters}")
        if iters == self.iters:
            return self
        return FaultPlan(self.n_clients, iters,
                         self.available[:iters], self.adversary[:iters])

    def describe(self, threshold: int | None = None) -> str:
        counts = self.available_counts
        parts = [f"FaultPlan(N={self.n_clients}, iters={self.iters}, "
                 f"available {int(counts.min())}..{int(counts.max())}"]
        if self.has_adversaries:
            parts.append(f", {int(self.adversary.any(axis=0).sum())} "
                         f"adversarial client(s)")
        if threshold is not None:
            parts.append(f", min headroom {int(self.headroom(threshold).min())}"
                         f" over threshold {threshold}")
        return "".join(parts) + ")"
