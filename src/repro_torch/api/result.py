"""TrainResult: the return value of api.fit, with the JAX package's schema
(plus the port's `device` and `timings`)."""

from __future__ import annotations

import dataclasses

import numpy as np


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def accuracy_of(w, x, y) -> float:
    """Binary accuracy of a VECTOR model w on (x, y); matrix models are
    scored by `workload.objective.score` (argmax semantics)."""
    w = np.asarray(w, np.float64)
    if w.ndim != 1:
        raise ValueError(
            f"accuracy_of scores (d,) vector models; got shape {w.shape} -- "
            f"score matrix models with workload.objective.score(w, x, y)")
    z = np.asarray(x, np.float64) @ w
    return float(((_sigmoid(z) > 0.5) == np.asarray(y)).mean())


def accuracy_curve(history, x, y, objective=None) -> np.ndarray:
    """Per-iteration score of the opened model trajectory (by
    `objective.score` when given, else binary accuracy of vector models)."""
    hist = np.asarray(history)
    if objective is not None:
        return np.asarray([objective.score(w, x, y) for w in hist])
    if hist.ndim != 2:
        raise ValueError(
            f"accuracy_of scores (d,) vector models; got shape "
            f"{hist.shape[1:]} -- pass objective= for matrix models")
    return np.asarray([accuracy_of(w, x, y) for w in hist])


@dataclasses.dataclass
class TrainResult:
    """What a fit() returns.

    weights        final opened model, float32 numpy: (d,) or (d, C)
    history        opened model after every step, (iters,) + model shape,
                   or None when the run was asked not to keep it
    accuracy       per-step eval score (iters,), or None without history
    final_accuracy score of `weights` on the workload's eval set
    per_class_accuracy
                   (C,) per-class accuracy for multi-class objectives
    wall_time_s    end-to-end wall time (setup + train + open), ending in
                   a device synchronise
    device         the device the run used ("cuda:0", "cpu")
    cost           modeled per-client comm/comp/enc seconds on the paper's
                   WAN parameters (core/cost_model), or None for protocols
                   the paper does not price (float, poly_float, secure_agg)
    timings        setup_s and iters_s: wall seconds of the setup and of the
                   iteration loop (each ending in a device synchronise);
                   a copml run on the eager or jit engine adds spans: its
                   repro_torch.obs spans, path -> [count, host seconds]
                   (perf_counter, no synchronise, so a phase that launches
                   kernels counts their launch), for setup.rows,
                   setup.share, setup.lcc and train.step (step.encode,
                   .masks, .open), with each random.threefry draw under
                   the phase that made it, e.g.
                   "train.step/step.masks/random.threefry";
                   a sharded run adds ranks: each rank's device, backend,
                   kernel launches by name and by GEMM path, peak device
                   memory, bytes sent by collective and loop seconds
    state          the protocol's final state: CopmlState / MpcState
                   (torch tensors on `device`), the SecureAggConfig of a
                   secure_agg run, None for the float protocols
    availability   the run's FaultPlan availability, bool (iters, N) (True =
                   the client contributed honestly and on time that step),
                   or None for a fault-free run
    measured_comm  MEASURED (not modeled) communication record of a
                   proc-engine run, None for the in-process engines:
                   bytes_by_phase / frames_by_phase (wire bytes/frames
                   actually sent, summed over every process, keyed by
                   protocol phase: setup, encode, exchange, trunc_open,
                   open_model), total_bytes, dropped_frames (stale frames
                   discarded at receivers), seconds_by_phase (per-phase
                   wall time, max over workers = the critical path),
                   degraded_steps (steps where some holder decoded from
                   a strict subset of owners), setup_wall_s, wall_s,
                   procs, iters (the JAX package's keys), and workers:
                   each rank's device, kernel launches by name and by
                   GEMM path, and GEMMs by shape.  Sits alongside `cost`
                   (the WAN model) for the measured-vs-modeled comparison
    """
    workload: str
    protocol: str
    engine: str
    iters: int
    weights: np.ndarray
    wall_time_s: float
    history: np.ndarray | None = None
    accuracy: np.ndarray | None = None
    final_accuracy: float | None = None
    per_class_accuracy: np.ndarray | None = None
    cost: dict | None = None
    device: str = "cpu"
    timings: dict | None = None
    state: object = None
    availability: np.ndarray | None = None
    measured_comm: dict | None = None

    @property
    def triple(self) -> tuple:
        """(workload, protocol, engine): the full run specification."""
        return (self.workload, self.protocol, self.engine)

    def summary(self) -> str:
        parts = [f"{self.workload} x {self.protocol} x {self.engine} "
                 f"on {self.device}:",
                 f"{self.iters} iters in {self.wall_time_s:.2f}s"]
        if self.final_accuracy is not None:
            parts.append(f"accuracy {self.final_accuracy:.3f}")
        if self.per_class_accuracy is not None:
            worst = np.nanmin(self.per_class_accuracy)
            parts.append(f"(worst class {worst:.3f} "
                         f"of {len(self.per_class_accuracy)})")
        if self.cost is not None:
            parts.append(f"modeled total {self.cost['total_s']:.0f}s "
                         f"(comm {self.cost['comm_s']:.0f}s)")
        if self.measured_comm is not None:
            mc = self.measured_comm
            parts.append(f"measured {mc['total_bytes'] / 1e6:.2f}MB "
                         f"over {mc['procs']} procs")
            if mc.get("degraded_steps"):
                parts.append(f"({mc['degraded_steps']} degraded steps)")
        if self.availability is not None:
            n = self.availability.shape[1]
            parts.append(f"churn: min {int(self.availability.sum(1).min())}"
                         f"/{n} clients available")
        return "  ".join(parts)
