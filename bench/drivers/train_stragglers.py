"""Training jobs back to back, with clients straggling in every step.

The mix is train_jobs' (the same closed loop of one user, the same job
records and judgement, by import), with every job run under a fault plan
of the port's (`api.faults.FaultPlan`): in each step `stragglers_per_step`
clients, drawn uniformly without replacement from the N, miss the round,
and the round decodes from the first R of the others (the plan's
`subsets`, passed as `step_subsets` on the jit engine; no dropouts, no
adversaries).  The draw is seeded from the run's seed and the job's
program key, itself a hash of the seed and the job's index, so each job
has a plan of its own and the same seed gives the same plans.  Decoding
from any R clients gives the same field element, so the reference's step
check judges the jobs as it judges fault-free ones.

Mix parameters: train_jobs' and `stragglers_per_step`.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from drivers import train_jobs
from yardstick import data

judge = train_jobs.judge


def run(h) -> dict:
    system = h.system
    h.system = types.SimpleNamespace(System=straggling(
        system.System, h.seed, int(h.mix["stragglers_per_step"])))
    try:
        return train_jobs.run(h)
    finally:
        h.system = system


def straggler_steps(seed: int, key, n: int, iters: int,
                    per_step: int) -> dict:
    """{step: clients that miss it} of one job: `per_step` distinct clients
    a step, uniform over the n, from (seed, the job's program key)."""
    key = np.asarray(key, np.uint64)
    gen = data.generator(seed, "schedule", "cpu",
                         int(key[0]) | int(key[1]) << 32)
    return {s: torch.randperm(n, generator=gen)[:per_step].tolist()
            for s in range(iters)}


def straggling(system_cls, seed: int, per_step: int):
    """The configuration's System whose every job runs under a straggler
    plan of its own."""

    class Straggling(system_cls):
        def job(self, key, client_xs, client_ys) -> dict:
            if not hasattr(self, "proto"):
                # the control: the plain reference on one set of rows,
                # which no decode subset can change
                return super().job(key, client_xs, client_ys)
            from repro_torch.api.faults import FaultPlan
            n, iters = self.cfg["n_clients"], self.cfg["iters"]
            r = self.copml_cfg.recovery_threshold
            steps = straggler_steps(seed, key, n, iters, per_step)
            plan = FaultPlan.from_schedule(n, iters, stragglers=steps)
            plan.validate(r, "straggler mix")
            timings: dict = {}
            state, w, hist = self._protocols.run_copml_engine(
                self.proto, "jit", key, client_xs, client_ys, iters,
                history=True, timings=timings, step_subsets=plan.subsets(r))
            return dict(w=w.cpu().numpy(), hist=hist.cpu().numpy(),
                        timings=timings, state=state)

    return Straggling
