"""What one step launches: the port's counterpart of launch/hlo_counter.py.

The JAX package's hlo_counter parses the compiled HLO and corrects its
loop bodies' counts.  Eager torch has no HLO and no loop that runs a body
once while a trace counts it once, so nothing is parsed here: a step is
run and recorded.

* `LaunchLog` spies on kernels/ops: every field-kernel call with its op,
  shapes, strides and (for a GEMM) the path plan.gemm_path gives it, in
  the phase "setup" inside the owner's setup and "step" after;
* `launch_rows` prices each recorded launch from its shapes with
  launch/roofline.py's formulas (operations and bytes);
* `profile_steps` takes device time by kernel name from torch.profiler
  over a few steps, with the device's idle share and its launches a step;
* `count_steps` does both over the same steps, and `collective_bytes`
  reads each rank's meshutil.Rank.sent_bytes by collective.

Their sum is the roofline's executed `ops`, `bytes` and
`coll_bytes_per_device` (`StepCount.roofline`).
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from ..kernels import ops
from ..kernels.plan import gemm_path
from . import roofline as RL

GEMM_OPS = ("modmatmul", "modmatmul_batched")


def gemm_key(a, b) -> tuple:
    """(A's shape, A's strides, B's shape, B's strides) of one GEMM."""
    return (tuple(a.shape), tuple(a.stride()), tuple(b.shape),
            tuple(b.stride()))


def path_of_key(ash, ast, bsh, bst) -> str:
    """plan.gemm_path of a GEMM given by its shapes and strides."""
    if len(ash) == 2:
        (m, k), n = ash, bsh[1]
    else:
        (_, m, k), n = ash, bsh[2]
    return gemm_path(m, k, bst[-1], n, ast[-2], ast[-1])


def _kernel_key(name: str, args) -> tuple:
    """The work parameters of a non-GEMM launch: (n, m, d, c, degree) of
    a gradient or fused step, (elements, degree) of poly_eval."""
    if name == "poly_eval":
        z, coeffs = args[:2]
        return (z.numel(), coeffs.numel() - 1)
    x, w, coeffs = args[:3]
    if name == "coded_gradient":
        return (1,) + tuple(x.shape) + (1, coeffs.numel() - 1)
    c = 1 if name == "coded_gradient_batched" else w.shape[-1]
    return tuple(x.shape) + (c, coeffs.numel() - 1)


class LaunchLog:
    """Counts every kernels/ops call made inside the `with` block.

    `calls`: GEMMs by (phase, op, A's shape, A's strides, B's shape, B's
    strides); `kernels`: the other field kernels by (phase, op, work
    parameters).  The phase is "setup" inside `owner`.setup (Copml's by
    default; "mpc_baseline": MpcBaseline's; None: every call is "step")."""

    def __init__(self, owner="copml"):
        self.calls: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.phase = "step"
        self.owner = owner

    def __enter__(self):
        from ..core import baselines, protocol
        self._cls = {"copml": protocol.Copml,
                     "mpc_baseline": baselines.MpcBaseline,
                     None: None}[self.owner]
        self._real = {name: getattr(ops, name) for name in ops.KERNELS}

        def spy(name):
            real = self._real[name]

            def call(*args, **kw):
                if name in GEMM_OPS:
                    self.calls[(self.phase, name)
                               + gemm_key(args[0], args[1])] += 1
                else:
                    self.kernels[(self.phase, name,
                                  _kernel_key(name, args))] += 1
                return real(*args, **kw)
            return call

        for name in ops.KERNELS:
            setattr(ops, name, spy(name))
        if self._cls is not None:
            self._setup = self._cls.setup

            def setup(proto, *args, **kw):
                self.phase = "setup"
                try:
                    return self._setup(proto, *args, **kw)
                finally:
                    self.phase = "step"

            self._cls.setup = setup
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(ops, name, real)
        if self._cls is not None:
            self._cls.setup = self._setup

    def counts(self, phase: str | None = None) -> dict:
        """Launches by op (of one phase, or all)."""
        out = {k: 0 for k in ops.KERNELS}
        for key, c in list(self.calls.items()) + list(self.kernels.items()):
            if phase is None or key[0] == phase:
                out[key[1]] += c
        return out


def launch_work(key: tuple) -> tuple:
    """(operations, bytes) of one launch given by its LaunchLog key
    without the phase: (op, A's shape, A's strides, B's shape, B's
    strides) for a GEMM, (op, work parameters) for the others."""
    op, *params = key
    if op in GEMM_OPS:
        return RL.gemm_work(*params)
    work = {"poly_eval": RL.poly_work,
            "fused_step": RL.fused_work}.get(op, RL.gradient_work)
    return work(*params[0])


def launch_rows(log: LaunchLog, phase: str | None = None) -> list:
    """Every recorded launch shape with its count, path, and operations
    and bytes per launch (launch/roofline.py's formulas)."""
    rows = []
    for key, count in sorted(list(log.calls.items())
                             + list(log.kernels.items()), key=str):
        if phase is not None and key[0] != phase:
            continue
        o, b = launch_work(key[1:])
        if key[1] in GEMM_OPS:
            path, shape = path_of_key(*key[2:]), f"{key[2]}@{key[4]}"
        else:
            path, shape = None, str(key[2])
        rows.append(dict(phase=key[0], op=key[1], path=path, shape=shape,
                         launches=count, ops=o, bytes=b))
    return rows


def work(rows: list) -> tuple:
    """(operations, bytes) summed over launch_rows."""
    return (sum(r["ops"] * r["launches"] for r in rows),
            sum(r["bytes"] * r["launches"] for r in rows))


def collective_bytes(reports: list) -> dict:
    """Bytes sent by collective, from each rank's report ("sent_bytes",
    meshutil.Rank.sent_bytes): every rank's, and the most any one rank
    sent ("per_device")."""
    per_rank = [dict(r["sent_bytes"]) for r in reports]
    totals = [sum(s.values()) for s in per_rank]
    return {"ranks": per_rank, "per_device": max(totals, default=0)}


def profile_steps(step, state, steps: int = 2, key=1) -> tuple:
    """`steps` more steps `state = step(key_t, state)` (key_t =
    fold_in(PRNGKey(key), t)) from `state` under torch.profiler: wall and
    device ms a step, the device's idle share and its launches a step, and
    the table of device time by kernel.  Device numbers are None where the
    profiler saw no device (a CPU run).  The heap is collected first, so
    that a collection of what earlier work left behind does not land in the
    few timed steps.  Returns (summary, table, state)."""
    from ..core import random as jrandom
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    gc.collect()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            state = step(jrandom.fold_in(jrandom.PRNGKey(key), t), state)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, memcpys): host ops also report the
    # device time of the kernels they launched
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {e.key: dict(count=e.count,
                             device_ms=e.self_device_time_total / 1e3)
                 for e in on_device}
    summary = dict(steps=steps, wall_ms_per_step=wall_ms / steps,
                   device_ms_per_step=None, idle_share=None,
                   device_kernels_per_step=None, device_by_kernel=by_kernel)
    if on_device:
        device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        summary.update(
            device_ms_per_step=device_ms / steps,
            idle_share=1.0 - device_ms / wall_ms,
            device_kernels_per_step=sum(e.count for e in on_device) / steps)
    table = events.table(sort_by="cuda_time_total" if on_device
                         else "cpu_time_total", row_limit=25)
    return summary, table, state


class StepCount(dict):
    """count_steps' record: the profile's keys, plus "launches" (field
    kernels a step by op), "rows" (launch_rows of the steps) and "ops" /
    "bytes" a step."""

    def roofline(self, name: str, *, chips: int = 1, model_ops: float = 0.0,
                 coll_bytes_per_device: float = 0.0,
                 link: str = "nvlink4") -> RL.Roofline:
        return RL.Roofline(name=name, chips=chips, ops=self["ops"],
                           bytes=self["bytes"],
                           coll_bytes_per_device=coll_bytes_per_device,
                           model_ops=model_ops, link=link)


def count_steps(step, state, steps: int = 2, key=1) -> StepCount:
    """Run `steps` steps (as profile_steps) under a LaunchLog and the
    profiler together: the field kernels launched, priced, and the
    device's time, idle share and launches, all a step."""
    with LaunchLog(owner=None) as log:
        summary, table, _ = profile_steps(step, state, steps, key)
    rows = launch_rows(log)
    o, b = work(rows)
    rec = StepCount(summary, table=table, rows=rows,
                    launches={k: v / steps for k, v in log.counts().items()},
                    ops=o / steps, bytes=b / steps)
    return rec
