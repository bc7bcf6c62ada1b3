#!/usr/bin/env python3
"""Run the PyTorch port of COPML on one CUDA card and check it end to end.

Phases (a failed phase fails the run; no failure is caught):
  1. build    compile the CUDA kernels from src/repro_torch/kernels/csrc
  2. kernels  hold every kernel (modmatmul, modmatmul_batched, fused_step,
              coded_gradient_batched, coded_gradient_matrix, coded_gradient,
              poly_eval) against its plain torch version (run on CPU copies:
              exact, bit for bit) at ragged shapes and at the main path's
              shapes; time each kernel and its plain version on the card
              with CUDA events, and by device time (torch.profiler).  The
              ragged shapes reach every branch of the redesigned kernels:
              the thin GEMM at M, K in {1, 8, 17, 50, 64, 65}, odd N,
              batch stride 0, a strided B that keeps the tiled path; the
              column-sum GEMM (X^T y) at K in {65, 4097, 8193, 9019,
              40000}, N in {1, 2, 3, 5, 10, 16}, odd M, a batch of 1, A 4
              bytes off a 16-byte line, a class-major B, one split, and
              x = y = p - 1 at K = 40000 and with 4096-row splits; the
              gradient kernel's three accumulator modes, clients off
              16-byte lines, bm = 3 and 7, m below one slice, X~ sizes not
              a multiple of 16 bytes, an X~ starting 4 bytes off, C = 1
              and 10, one adversary's offset, and x = w = p - 1 at
              d = 40000 (pass 1's lane sums past 2^58); poly_eval on both
              kernels (short; grid-stride past one wave), at degrees 0 to 63, z 4 bytes off and
              z = every coefficient = p - 1; the row-dot GEMM (A K-contiguous,
              N <= 16) at M in {1, 31, 3006}, K in {65, 3073, 4097, 9019,
              60000}, N in {1, 10, 16}, K past one staged chunk of B, batch
              stride 0, A 4 bytes off a 16-byte line and x = y = p - 1; the
              split-K GEMM (M <= 128, K > 64) at M in {1, 31, 128}, K in
              {65, 3073, 4097, 9019}, N in {1, 50, 130, 500}, one split
              (no combine), splits of several 64-row passes, batch stride
              0, A 4 bytes off and x = y = p - 1; the tiled GEMM on a
              K-contiguous A and a strided B; then the two new paths at the
              other protocols' full shapes: the MPC baseline's Z = X W
              (16, 3006, 3073) @ (16, 3073, C), C = 1 and 10, on the row-dot
              kernel, and serving's (B, 3073) @ (3073, 50), B = 1, 32, 128,
              on the split-K kernel (--quick: cuts of both); then the
              shapes a proc:4 worker gives the kernels: coded_gradient_batched
              (13, 902, 3073) with the last rank's 2 zero-padded clients,
              coded_gradient_matrix (4, 98, 24, 10) with 3, and every field
              GEMM of a worker's step at its strides (worker.step_gemms),
              each on the thin kernel
  3. golden   api.fit on cuda reproduces the smoke goldens (weights, share
              and history sha256) and the pinned mnist10_like /
              linreg_smoke / cifar10_like / smoke_straggler shas of the JAX
              package's runs, on the fused schedule and on the siloed one
              (REPRO_FUSED_STEP=0); smoke_straggler under a fault plan
              gives the JAX package's shas on both schedules; the MPC
              baseline (bh08, bgw) and three secure_agg aggregation rounds
              give the JAX package's pinned shas (MPC_SHAS, AGG_SHAS), and
              smoke serving of a copml and a float result equals
              reference_scores
  4. full     api.fit("cifar10_case2", "copml", "jit", iters=5) on the card
              at the paper's full width (N=50, m=9019, d=3073, K=10, T=7);
              kernel launch counts are reset just before it and read just
              after, and the last step's fused_step operands are re-checked
              against the plain version; every field GEMM of the fit is
              counted by shape, path and phase (setup, step), re-checked
              and timed by device time; no GEMM of the fit may take the
              tiled kernel (X^T y takes the column-sum kernel)
  5. siloed   the same fit on the siloed schedule: coded_gradient_batched
              once per step, fused_step never, the last step's operands
              re-checked, weights and history equal to the fused run's,
              its GEMMs by shape and path as in phase 4;
              then mnist10_like on the siloed schedule (the matrix kernel)
  6. faulty   the full fit under a fault plan (a straggler, and from step 3
              an adversary: exactly R = 49 available), on both schedules:
              weights and history equal to the fault-free run's, and the
              fused step's adversary offset non-zero at steps 3 and 4,
              its GEMMs by shape and path as in phase 4
  7. protocols  api.fit(FULL_WORKLOAD, p, "jit", iters=5) for p in
              mpc_baseline, secure_agg, float, poly_float, each with its
              counts reset just before and read just after: setup s,
              ms/iter, peak memory, a profile of two more steps (device ms
              per step, idle share, kernels per step), accuracy; the GEMMs
              of mpc_baseline (its Z = X W on the row-dot kernel) and
              secure_agg by shape and path, none on the tiled kernel;
              float's eager (float64) run
              within 1e-3 of its jit (float32) one; copml's and
              mpc_baseline's device ms per step beside cost_model's
              MODELLED speedup (the single card simulates compute only)
  8. serve    api.serve on the full-width copml result (re-shared, never
              opened): 1024 eval queries at batch 1, 32 and 128, every
              window's field logits equal to reference_scores of the
              opened model bit for bit; queries/s, encode s, device ms per
              window; the windows' GEMMs by shape and path (scores on the
              split-K kernel, opens on the thin one, none on the tiled
              kernel); the float result (fallback encode) at batch 128
  9. proc     api.fit(FULL_WORKLOAD, "copml", "proc:4", iters=5): four
              worker processes over localhost sockets, each with its own
              CUDA context on the card, bit-equal to phase 4's jit fit
              (weights, shares, history); frames by phase equal to
              cost_model.proc_net_frames; every worker on cuda, its
              coded_gradient_batched once a step, no GEMM on the tiled
              kernel; setup, wall, ms/iter, MB and seconds by phase and the
              coordinator's peak memory, beside cost_model's modelled
              communication; then smoke_straggler with rank 3's links 0.35 s
              slow (degraded steps, bit-equal to jit), mnist10_like proc:4
              (coded_gradient_matrix in the workers, bit-equal to jit), and
              the CLI: `python -m repro_torch.api.cli smoke --iters 10` and
              its `serve` (serve_main) as subprocesses, and in-process, where
              the fit lands on GOLDEN_W

Output: one {"kernels": [...]} JSON line (the seven TPU kernels' ports,
then the row-dot and split-K paths of modmatmul as entries of their own,
each with its launches on the full-width path that runs it, its launches
by path -- the proc:4 runs' summed over the coordinator and the workers --
and its time at a proc worker's shape where it runs there), the card's
name and power limit (nvidia-smi), then {"ok": true, "device": {...}} as
the last line.
Details (per-shape timings, poly_eval's device time at L = 45,100 and 2^26,
the ptxas report, a profile of two steps) go to chip_smoke.json in OUT_DIR.

  python3 chip_smoke.py            # every phase (needs one CUDA card)
  python3 chip_smoke.py --quick    # build, ragged kernel checks, goldens
      # (phases 1-3)
  python3 chip_smoke.py --compare OTHER/src   # the redesigned kernels of
      # another checkout (e.g. the parent commit's) and of this one, timed
      # in turns other, this, this, other; writes chiprun_out/compare.json
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"

# smoke, key 0, 10 iterations (the JAX package's pinned goldens)
GOLDEN_W = [0.25, -0.375, 0.375, 0.5, -0.125, 0.25, 0.875, 1.25, -0.5,
            -1.125, -0.5, 0.125]
GOLDEN_SHARES_SHA = \
    "459aaa671b3d6708b4918f1e54b29e083cecf6c85b5b617f882720596399afaf"
GOLDEN_HIST_SHA = \
    "343e87b79c6ece3608774a43160dccbb80ef214111bdb0f9f9c066ead77f9e80"
# (workload, iters) -> (shares sha, history sha) of the JAX package's
# api.fit(..., "copml", "jit", key=0) with the legacy threefry stream
PINNED = {
    ("mnist10_like", 3): (
        "ec665a028963a34ad6d3db0b2d5edadffb6e8bc51bb0c16bae48c7fcb5b1fe93",
        "081ef4be1cf1058e8eb2291105a8f176891e1d063c9f047cd5168927862b09f4"),
    ("linreg_smoke", 3): (
        "b73e3759792db9706b1c7cde248419d1ea5989f68a7d262fcdf19a757d9a018e",
        "6aeda2a10e06f4e07df80e48c6ff8f17d1dd5470eac3b7cf4ed941f31f172359"),
    ("cifar10_like", 3): (
        "a6b0724d58966fca077bbffbbfa518e42b8c692e5f347ab7ca5e5850be8bca8c",
        "01df5eac47631ff6c7df2421dadb4469a826034da4fe8f58dc2a1978b6c26bc2"),
    ("smoke_straggler", 4): (
        "a475aab02794841823767404680ec5a9ea337a869c1503fc449c2ddc0c2179da",
        "7ece876243ab5f5a5015f937a52c9f3374642f42ff6b4d36009288148a2fbae6"),
}
# smoke_straggler, key 0, 6 iterations under FAULT_SCHEDULE: the JAX
# package's (shares sha, history sha), the same on both of its schedules
FAULT_SCHEDULE = dict(stragglers={1: (0, 1), 4: (2,)}, dropouts={2: (7,)},
                      adversaries={3: (8,)})
FAULTY_SHAS = (
    "239bb5c60a80c270b9417cf6025b80b18ef8a8dcb900ecda07ab9b289593352d",
    "d0a119966962c28edbfed2d3e6d6dffc3fc2413e49d189dc8148748d4147b86a")
# smoke, key 0, 3 iterations of the JAX package's MpcBaseline (setup on
# split(key)[0], step t on fold_in(split(key)[1], t)), per scheme: (shares
# sha, opened weights sha); tests/test_torch_baselines.py pins them to the
# JAX package's output
MPC_SHAS = {
    "bh08": (
        "019dbdc15dc77aff99326e28e7d464b219bb396a9c1c72adfc7dc19203d674b6",
        "42186769463d1e557bc491edeb7d6b19f2f6622ec9f387de55eccaa4b0e47a52"),
    "bgw": (
        "425edf1e754c9f621b31e5f6047416c970ef60aebd9f71f669fd41569f6666b3",
        "42186769463d1e557bc491edeb7d6b19f2f6622ec9f387de55eccaa4b0e47a52"),
}
# three secure_agg aggregation rounds at smoke's shape (N=13, T=1, d=12) on
# seeded float32 gradients (agg_rounds): (holder sum shares sha, opened
# means sha); tests/test_torch_protocols.py pins them to the JAX package's
AGG_SHAS = (
    "83fc0f624b081f02e9f2d29c7acfa322fd5943b71d14a64e562c619f4bfa807e",
    "25906cd78ab428db0f7949c1a4bbd8c042e072646ed0cf8ec102480a13e8aaa6")
FULL_WORKLOAD = "cifar10_case2"
FULL_ITERS = 5

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT32_OPS_PER_S = 67e12        # H100 SXM 32-bit CUDA-core rate (fp32 table)

# the kernels each full-width path launches (every one at least once)
FUSED_PATH = ("modmatmul", "modmatmul_batched", "fused_step")
SILOED_PATH = ("modmatmul", "modmatmul_batched", "coded_gradient_batched")
# the other protocols' and serving's paths (float GD runs no field kernel)
PROTOCOL_PATHS = {"mpc_baseline": ("modmatmul", "modmatmul_batched"),
                  "secure_agg": ("modmatmul",), "float": (),
                  "poly_float": ()}
SERVE_PATH = ("modmatmul",)
SERVE_BATCHES = (1, 32, 128)
SERVE_QUERIES = 1024
PROC_N = 4
PROC_ENGINE = f"proc:{PROC_N}"
# rank 3's frames arrive 0.35 s late everywhere; the others decode after
# 0.05 s without its blocks
STRAGGLER_NET = dict(links=((3, None, 0.35),), decode_timeout_s=0.05)

TPU_KERNEL = {
    "modmatmul": "src/repro/kernels/modmatmul.py:70",
    "modmatmul_batched": "src/repro/kernels/modmatmul.py:106",
    "fused_step": "src/repro/kernels/fused_step.py:138",
    "coded_gradient_batched": "src/repro/kernels/coded_gradient.py:215",
    "coded_gradient_matrix": "src/repro/kernels/coded_gradient.py:183",
    "coded_gradient": "src/repro/kernels/coded_gradient.py:120",
    "poly_eval": "src/repro/kernels/field_poly.py:30",
    "modmatmul_batched.rowdot": "src/repro/kernels/modmatmul.py:106",
    "modmatmul.splitk": "src/repro/kernels/modmatmul.py:70",
}
SOURCE = {
    "modmatmul": "src/repro_torch/kernels/csrc/modmatmul.cu",
    "modmatmul_batched": "src/repro_torch/kernels/csrc/modmatmul.cu",
    "fused_step": "src/repro_torch/kernels/csrc/fused_step.cu",
    "coded_gradient_batched": "src/repro_torch/kernels/csrc/coded_gradient.cu",
    "coded_gradient_matrix": "src/repro_torch/kernels/csrc/coded_gradient.cu",
    "coded_gradient": "src/repro_torch/kernels/csrc/coded_gradient.cu",
    "poly_eval": "src/repro_torch/kernels/csrc/field_poly.cu",
    "modmatmul_batched.rowdot": "src/repro_torch/kernels/csrc/modmatmul.cu",
    "modmatmul.splitk": "src/repro_torch/kernels/csrc/modmatmul.cu",
}
# the modmatmul paths with entries of their own in the kernels line: the
# GEMM path, and the full-width run whose launches they report
PATH_ENTRIES = {"modmatmul_batched.rowdot": ("rowdot", "mpc_baseline"),
                "modmatmul.splitk": ("splitk", "serve")}


def log(*args):
    print(*args, flush=True)


def run_counts() -> dict:
    """The launch counts since the last ops.reset_launches(): each kernel's,
    and the field GEMM's by path under "gemm:<path>"."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    counts.update({f"gemm:{p}": c for p, c in ops.gemm_path_counts().items()})
    return counts


def sha(arr, dtype) -> str:
    import numpy as np
    return hashlib.sha256(np.asarray(arr, dtype).tobytes()).hexdigest()


def mpc_smoke(scheme: str, device) -> tuple:
    """(shares sha, weights sha) of MpcBaseline on smoke, key 0, 3
    iterations (MPC_SHAS)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import baselines
    wl = api.get_workload("smoke")
    x, y, _, _ = wl.data()
    mb = baselines.MpcBaseline(wl.cfg, wl.m, wl.d, scheme=scheme,
                               device=device)
    state, w = mb.train(0, x, y, 3)
    return (sha(state.w_shares.cpu().numpy(), np.int32),
            sha(w.cpu().numpy(), np.float32))


def agg_gradients(np, t: int, n: int, d: int):
    """Round t's float32 gradients (N, d) for agg_rounds: normal with
    scale 4, so some pass the clip of 8."""
    return np.random.default_rng(t).normal(0.0, 4.0, (n, d)).astype(
        np.float32)


def agg_rounds(device) -> tuple:
    """Three aggregation rounds at smoke's shape on agg_gradients, round t
    on fold_in(PRNGKey(0), t), round 2 reconstructing from holders (3, 5):
    (sha of the holders' sum shares (3, N, d), sha of the means (3, d))."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import random as jrandom
    from repro_torch.core import secure_agg
    wl = api.get_workload("smoke")
    cfg = secure_agg.SecureAggConfig(n_clients=wl.n_clients, t=wl.cfg.t)
    sel = secure_agg.selection_arrays(cfg, [(3, 5)], device)
    sums, means = [], []
    for t in range(3):
        g = torch.from_numpy(agg_gradients(np, t, cfg.n_clients, wl.d))
        keys = jrandom.split(jrandom.fold_in(jrandom.PRNGKey(0), t),
                             cfg.n_clients + 1)
        shares = secure_agg.encode_all(keys[:cfg.n_clients], g.to(device),
                                       cfg)
        sums.append(secure_agg.aggregate_shares(shares))
        means.append(secure_agg.decode_mean(
            keys[cfg.n_clients], sums[-1], cfg, None,
            (sel[0][0], sel[1][0]) if t == 2 else None))
    return (sha(torch.stack(sums).cpu().numpy(), np.int32),
            sha(torch.stack(means).cpu().numpy(), np.float32))


class Checker:
    """Runs kernel-vs-plain comparisons and keeps per-kernel records."""

    def __init__(self, torch, np, P):
        self.torch, self.np, self.P = torch, np, P
        self.rng = np.random.default_rng(0)
        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(0)
        self.max_err = {k: 0 for k in TPU_KERNEL}
        self.checks = {k: 0 for k in TPU_KERNEL}
        self.rows: list = []

    def field(self, *shape):
        """Uniform field elements on the card, from a seeded generator."""
        return self.torch.randint(0, self.P, shape, dtype=self.torch.int32,
                                  device="cuda", generator=self.gen)

    def compare(self, name, got, want, what):
        got = got.cpu().to(self.torch.int64)
        want = want.cpu().to(self.torch.int64)
        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        self.checks[name] += 1
        if err:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = "
                                 f"{err} (must be 0)")

    def time_ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(torch, fn, reps: int):
    """Device time per call of `fn` (every kernel and memset it launches,
    each once a call), from torch.profiler's CUDA activity over `reps`
    calls after a warm-up: for calls of a few microseconds the host's
    wrapper time would swamp a CUDA-event timing of back-to-back calls.

    Each kernel name runs once a call, so its mean time, summed over
    names, stands even when the profiler drops a launch at the window's
    edge (seen on an H100: 2 of 3 launches kept).  A window with no device
    activity at all (also seen there) is taken again; after three such
    windows the device time is not measured and None is returned (callers
    keep their CUDA-event time under its own key, never as device time)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()                           # the window's edge
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.count]
        if events:
            return sum(e.self_device_time_total / e.count
                       for e in events) / 1e3
    log("device_ms: the profiler saw no device time in three windows; "
        "device time not measured")
    return None


def strided_field(ck: "Checker", shape, stride):
    """Random field elements viewed with `shape` and `stride` (a stride may
    be 0, as for a broadcast operand); returns (view, its storage)."""
    size = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    base = ck.field(size)
    return ck.torch.as_strided(base, shape, stride), base


def grad_label(n, m, d, c) -> str:
    """The gradient kernel's plan at a shape, and whether X~'s size is a
    multiple of 16 bytes and its clients start on 16-byte lines."""
    from repro_torch.kernels.plan import gradient_plan
    pl = gradient_plan(m, d, c)
    return (f"[{pl['mode']} bm={pl['bm']} stages={pl['stages']} "
            f"size%16={(4 * n * m * d) % 16} client%16={(4 * m * d) % 16}]")


# (batch, M, K, N, A's offset in words, x = y = p - 1, B class-major, kc):
# the column-sum GEMM's ragged cases; kc None takes plan.colsum_launch's
# splits, else splits of kc rows (4096: a lane's most terms; 100: a ragged
# 32-row block at the end of every split)
COLSUM_CASES = [
    (3, 33, 65, 1, 0, False, False, None),      # K just past the thin path
    (2, 257, 4097, 2, 0, False, False, None),
    (1, 3073, 8193, 10, 0, False, False, None),  # a batch of 1
    (2, 95, 9019, 16, 1, False, False, None),   # A 4 bytes off a 16B line
    (1, 129, 40000, 1, 0, True, False, None),   # worst sums, largest K
    (13, 24, 390, 10, 0, False, False, None),   # mnist10_like's setup
    (2, 100, 20, 3, 0, False, False, None),     # one split: no combine
    (2, 70, 300, 5, 0, False, True, None),      # B class-major
    (1, 40, 8193, 2, 0, True, False, 4096),     # 4096 products of p - 1
    (2, 70, 4096, 1, 0, True, False, 4096),
    (2, 65, 1000, 10, 0, False, False, 100)]


def colsum_checks(ck: Checker, paths: dict) -> None:
    """The column-sum GEMM at COLSUM_CASES against the plain version, each
    counted in `paths`."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import plan, ref
    for (b, m, k, n, off, worst, b_strided, kc) in COLSUM_CASES:
        xt = ck.field(off + b * k * m)[off:].view(b, k, m).transpose(1, 2)
        y = ck.field(b, n, k).transpose(1, 2) if b_strided else \
            ck.field(b, k, n)
        if worst:
            xt.fill_(ck.P - 1)
            y.fill_(ck.P - 1)
        path = mm.path_of(xt, y)
        assert path == "colsum", (b, m, k, n, path)
        paths[path] += 1
        if kc is None:
            got = mm.modmatmul_batched(xt, y)
            kc = plan.colsum_launch(m, n, k, b, torch.cuda.get_device_properties(
                0).multi_processor_count)["kc"]
        else:
            splits = -(-k // kc)
            launch = dict(cmax=next(c for c in plan.COLSUM_CMAX if n <= c),
                          kc=kc, splits=splits,
                          ctas=-(-(b * -(-m // 32) * splits)
                                 // plan.COLSUM_WARPS))
            got = mm.colsum(xt, y, torch.empty((b, m, n), dtype=torch.int32,
                                               device="cuda"), launch)
        ck.compare("modmatmul_batched", got,
                   ref.modmatmul_batched(xt.cpu(), y.cpu()),
                   f"colsum ({b},{m},{k})@({b},{k},{n}) offset {off} kc {kc}"
                   f"{' p - 1' if worst else ''}"
                   f"{' B class-major' if b_strided else ''}")


# (batch, M, K, N, A's offset in words, x = y = p - 1, A's batch stride 0):
# the row-dot GEMM's ragged cases (A K-contiguous, N <= 16, past the thin
# path); K = 4097 / 9019 at N = 16 and 10, and K = 60000 at N = 1, pass
# one staged chunk of B (plan.rowdot_shape), so later chunks add into the
# output
ROWDOT_CASES = [
    (3, 1, 65, 1, 0, False, False),
    (2, 31, 3073, 10, 1, False, False),         # A 4 bytes off a 16B line
    (1, 3006, 4097, 16, 0, False, False),
    (2, 31, 9019, 1, 0, True, False),           # worst sums
    (4, 31, 3073, 10, 0, False, True),          # batch stride 0
    (1, 31, 9019, 10, 3, True, False),          # chunks of B, worst sums
    (2, 3, 60000, 1, 0, True, False),           # two chunks at C = 1
    (3, 100, 300, 2, 0, False, False),
    (2, 65, 40, 4, 0, False, False)]            # K <= 64, M past thin
# (batch, M, K, N, A's offset, x = y = p - 1, A's batch stride 0, forced):
# the split-K GEMM's ragged cases (M <= 128, K > 64); `forced` calls the
# kernel directly with plan.splitk_launch where gemm_path would take
# another path (N = 1 with a K-contiguous A is row-dot's)
SPLITK_CASES = [
    (1, 1, 65, 50, 0, False, False, False),
    (1, 31, 3073, 130, 1, False, False, False),  # A 4 bytes off
    (2, 128, 4097, 500, 0, False, True, False),  # batch stride 0
    (1, 1, 9019, 50, 0, True, False, False),     # worst sums
    (1, 128, 3073, 50, 0, True, False, False),
    (1, 31, 9019, 1, 0, False, False, True),     # N = 1
    (300, 2, 65, 50, 0, False, False, False),    # one split: no combine
    (2, 5, 9019, 500, 0, True, False, False),    # splits of 3 passes
    (1, 128, 65, 1, 0, True, False, True)]


def gemm_case(ck: Checker, b, m, k, n, off, worst, bcast):
    """A (b, m, k) K-contiguous, `off` words into its buffer (one (m, k)
    expanded over the batch with `bcast`), and B (b, k, n); x = y = p - 1
    with `worst`."""
    rows = 1 if bcast else b
    a = ck.field(off + rows * m * k)[off:].view(rows, m, k)
    y = ck.field(b, k, n)
    if worst:
        a.fill_(ck.P - 1)
        y.fill_(ck.P - 1)
    return (a.expand(b, m, k) if bcast else a), y


def new_path_checks(ck: Checker, paths: dict) -> None:
    """The row-dot and split-K GEMMs at ROWDOT_CASES and SPLITK_CASES
    against the plain version, each counted in `paths`."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import plan, ref
    for (b, m, k, n, off, worst, bcast) in ROWDOT_CASES:
        a, y = gemm_case(ck, b, m, k, n, off, worst, bcast)
        assert mm.path_of(a, y) == "rowdot", (b, m, k, n)
        paths["rowdot"] += 1
        ck.compare("modmatmul_batched.rowdot", mm.modmatmul_batched(a, y),
                   ref.modmatmul_batched(a.cpu(), y.cpu()),
                   f"rowdot ({b},{m},{k})@({b},{k},{n}) offset {off}"
                   f" kch {plan.rowdot_shape(n, k)['kch']}"
                   f"{' p - 1' if worst else ''}"
                   f"{' batch stride 0' if bcast else ''}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (b, m, k, n, off, worst, bcast, forced) in SPLITK_CASES:
        a, y = gemm_case(ck, b, m, k, n, off, worst, bcast)
        launch = plan.splitk_launch(m, n, k, b, sms)
        if forced:
            got = mm.splitk(a, y, torch.empty((b, m, n), dtype=torch.int32,
                                              device="cuda"), launch)
        else:
            assert mm.path_of(a, y) == "splitk", (b, m, k, n)
            got = mm.modmatmul_batched(a, y)
        paths["splitk"] += 1
        ck.compare("modmatmul.splitk", got,
                   ref.modmatmul_batched(a.cpu(), y.cpu()),
                   f"splitk ({b},{m},{k})@({b},{k},{n}) offset {off} "
                   f"splits {launch['splits']} x kc {launch['kc']}"
                   f"{' p - 1' if worst else ''}"
                   f"{' batch stride 0' if bcast else ''}")


def phase_kernels(ck: Checker, quick: bool) -> dict:
    """Ragged and main-path checks; returns the JSON rows per kernel."""
    torch = ck.torch
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref

    # -- ragged shapes: every tile shape, K past the 2048-term reduce,
    #    strided (transposed) and broadcast operands
    for (m, k, n) in [(5, 37, 101), (50, 7, 1000), (1, 8, 4099),
                      (33, 3000, 17), (20, 2500, 5), (3, 5000, 300),
                      (64, 64, 64), (65, 17, 129)]:
        a, b = ck.field(m, k), ck.field(k, n)
        ck.compare("modmatmul", mm.modmatmul(a, b),
                   ref.modmatmul(a.cpu(), b.cpu()), f"({m},{k})@({k},{n})")
    at, bt = ck.field(40, 30), ck.field(70, 40)
    ck.compare("modmatmul", mm.modmatmul(at.t(), bt.t()),
               ref.modmatmul(at.t().cpu(), bt.t().cpu()), "transposed views")
    # the tiled kernel's three tile shapes past its 2048-term reduce, with a
    # K-contiguous A (the padded As rows) and a K-contiguous B (padded Bs)
    for (m, k, n, a_step, b_t) in [(200, 2500, 9, 2, False),
                                   (8, 2100, 300, 1, True),
                                   (150, 2100, 40, 1, True)]:
        a = ck.field(m, k * a_step)[:, ::a_step]
        b = ck.field(n, k).t() if b_t else ck.field(k, n)
        assert mm.path_of(a[None], b[None]) == "tiled", (m, k, n)
        ck.compare("modmatmul", mm.modmatmul(a, b),
                   ref.modmatmul(a.cpu(), b.cpu()),
                   f"tiled ({m},{k})@({k},{n}) A K-stride {a_step}"
                   f"{' B transposed' if b_t else ''}")
    # thin path: every M x K in {1, 8, 17, 50, 64, 65}^2 at an odd N (rows
    # start 4, 8 or 12 bytes off a 16-byte line), past the grid's stride,
    # and a strided B (M, K <= 64) that must keep the tiled path
    paths = dict.fromkeys(("thin", "colsum", "rowdot", "splitk", "tiled"), 0)
    sizes = (1, 8, 17, 50, 64, 65)
    for m in sizes:
        for k in sizes:
            a, b = ck.field(m, k), ck.field(k, 2053)
            path = mm.path_of(a[None], b[None])
            paths[path] += 1
            ck.compare("modmatmul", mm.modmatmul(a, b),
                       ref.modmatmul(a.cpu(), b.cpu()),
                       f"{path} ({m},{k})@({k},2053)")
    a, b = ck.field(50, 7), ck.field(7, 2_500_001)
    out = mm.modmatmul(a, b)
    for cols in (slice(0, 3000), slice(2_497_001, 2_500_001)):
        ck.compare("modmatmul", out[:, cols],
                   ref.modmatmul(a.cpu(), b[:, cols].cpu()),
                   "thin (50,7)@(7,2500001) grid stride")
    a8, bt = ck.field(8, 7), ck.field(300, 7).t()      # B's columns strided
    assert mm.path_of(a8[None], bt[None]) == "tiled"
    paths["tiled"] += 1
    ck.compare("modmatmul", mm.modmatmul(a8, bt),
               ref.modmatmul(a8.cpu(), bt.cpu()), "tiled strided B (8,7)@(7,300)")
    ab = ck.field(50, 17)[None].expand(6, 50, 17)
    bb = ck.field(6, 17, 1001)
    ck.compare("modmatmul_batched", mm.modmatmul_batched(ab, bb),
               ref.modmatmul_batched(ab.cpu(), bb.cpu()),
               "thin batch stride 0 (6,50,17)@(6,17,1001)")
    colsum_checks(ck, paths)
    new_path_checks(ck, paths)
    for (bsz, m, k, n) in [(3, 17, 40, 19), (13, 24, 13, 10), (2, 1, 9, 7)]:
        a, b = ck.field(bsz, m, k), ck.field(bsz, k, n)
        ck.compare("modmatmul_batched", mm.modmatmul_batched(a, b),
                   ref.modmatmul_batched(a.cpu(), b.cpu()),
                   f"({bsz},{m},{k})@({bsz},{k},{n})")
    x = ck.field(5, 2100, 300)
    y = ck.field(5, 2100, 1)
    assert mm.path_of(x.transpose(1, 2), y) == "colsum"
    paths["colsum"] += 1
    ck.compare("modmatmul_batched", mm.modmatmul_batched(x.transpose(1, 2), y),
               ref.modmatmul_batched(x.cpu().transpose(1, 2), y.cpu()),
               "colsum transposed X^T y")
    log(f"kernels: GEMM checks by path {paths}")
    row = ck.field(13)
    mix = ck.field(13, 13, 240)
    ck.compare("modmatmul_batched",
               mm.modmatmul_batched(row[None, None].expand(13, 1, 13), mix),
               ref.modmatmul_batched(row.cpu()[None, None].expand(13, 1, 13),
                                     mix.cpu()), "broadcast decode row")
    for (n, m, d, c, deg) in [(5, 37, 29, 1, 1), (13, 37, 29, 10, 1),
                              (5, 20, 3073, 1, 3), (13, 130, 24, 10, 1),
                              (3, 37, 29, 1, 1), (4, 45, 4000, 1, 1),
                              (2, 19, 3073, 10, 3), (2, 3, 40000, 1, 1),
                              (3, 3, 24, 1, 1)]:
        ops_ = fused_operands(ck, n, m, d, c, deg)
        if n == 3:                         # the fault form: one adversary
            adv = torch.zeros(n, dtype=torch.int32, device="cuda")
            adv[1] = 1 << 20
            ops_["args"] = ops_["args"][:3] + (adv,) + ops_["args"][4:]
        got = fs.fused_step(*ops_["args"], **ops_["kw"])
        want = ref.fused_step(*[t.cpu() for t in ops_["args"]], **ops_["kw"])
        mode = grad_label(n, m, d, c)
        for g, w_, what in zip(got, want, ("f", "new_w")):
            ck.compare("fused_step", g, w_,
                       f"N={n} m={m} d={d} C={c} {mode} {what}")
    # x = w = p - 1 past d = 32768: pass 1's lane sums pass 2^58
    ops_ = fused_operands(ck, 2, 3, 40000, 1, 1)
    for t in ops_["args"][:2]:
        t.fill_(ck.P - 1)
    got = fs.fused_step(*ops_["args"], **ops_["kw"])
    want = ref.fused_step(*[t.cpu() for t in ops_["args"]], **ops_["kw"])
    for g, w_, what in zip(got, want, ("f", "new_w")):
        ck.compare("fused_step", g, w_, f"N=2 m=3 d=40000 x = w = p - 1 {what}")
    log(f"kernels: ragged checks passed {dict(ck.checks)}")
    if quick:
        return {}

    # -- the main path's shapes at cifar10_case2 (N=50, K=10, T=7,
    #    m=9019, d=3073, mk=902) and mnist10_like (C=10)
    rows = {}
    n_cl, m_rows, d, kk, t, mk = 50, 9019, 3073, 10, 7, 902
    # Shamir share of X: (N, T) @ (T, m*d), the setup's largest GEMM
    a, b = ck.field(n_cl, t), ck.field(t, m_rows * d)
    out = mm.modmatmul(a, b)
    ncols = b.shape[1]
    for cols in (slice(0, 4096), slice(ncols - 4096, ncols)):
        ck.compare("modmatmul", out[:, cols],
                   ref.modmatmul(a.cpu(), b[:, cols].cpu()), "share X slice")
    del out
    ms = ck.time_ms(lambda: mm.modmatmul(a, b), 5)
    dev = device_ms(torch, lambda: mm.modmatmul(a, b), 5)
    plain = ck.time_ms(lambda: ref.modmatmul(a, b), 1)
    bb, by = bound(4.0 * (a.numel() + b.numel() + n_cl * b.shape[1]),
                   2.0 * n_cl * t * b.shape[1])
    rows["modmatmul"] = dict(shape=f"({n_cl},{t})@({t},{b.shape[1]})",
                             ms=ms, device_ms=dev, plain_ms=plain,
                             bound_ms=bb, bound_by=by)
    del a, b
    torch.cuda.empty_cache()
    # per-shape detail: LCC encode, reconstruct, per-iteration GEMMs
    for label, (m, k, n) in {
            "lcc_encode (setup, per holder)": (n_cl, kk + t, mk * d),
            "reconstruct coded X (setup)": (1, t + 1, n_cl * mk * d),
            "share (per iteration, mix)": (n_cl, t, n_cl * d),
            "reconstruct all holders (per iteration)": (1, n_cl, n_cl * d),
            "open model (per iteration)": (1, t + 1, d)}.items():
        a, b = ck.field(m, k), ck.field(k, n)
        ck.compare("modmatmul", mm.modmatmul(a, b)[:, :2048],
                   ref.modmatmul(a.cpu(), b[:, :2048].cpu()), label)
        ms_ = ck.time_ms(lambda: mm.modmatmul(a, b), 10)
        dev_ = device_ms(torch, lambda: mm.modmatmul(a, b), 10)
        pl_ = ck.time_ms(lambda: ref.modmatmul(a, b), 1)
        bb_, _ = bound(4.0 * (a.numel() + b.numel() + m * n), 2.0 * m * k * n)
        ck.rows.append(dict(kernel="modmatmul", what=label,
                            shape=f"({m},{k})@({k},{n})", ms=ms_,
                            device_ms=dev_, plain_ms=pl_, bound_ms=bb_))
        del a, b
    torch.cuda.empty_cache()

    # X^T y: (N, d, m) transposed view of the shares @ (N, m, C), on the
    # column-sum kernel; C = 10 is a 10-class objective at the same width
    x = ck.field(n_cl, m_rows, d)
    for c in (1, 10):
        y = ck.field(n_cl, m_rows, c)
        assert mm.path_of(x.transpose(1, 2), y) == "colsum"
        out = mm.modmatmul_batched(x.transpose(1, 2), y)
        for i in (0, n_cl - 1):
            ck.compare("modmatmul_batched", out[i],
                       ref.modmatmul(x[i].cpu().t(), y[i].cpu()),
                       f"X^T y C={c} [{i}]")
        ms = ck.time_ms(lambda: mm.modmatmul_batched(x.transpose(1, 2), y),
                        5)
        dev = device_ms(torch, lambda: mm.modmatmul_batched(
            x.transpose(1, 2), y), 5)
        plain = ck.time_ms(
            lambda: ref.modmatmul_batched(x.transpose(1, 2), y), 1)
        bb, by = bound(4.0 * (x.numel() + y.numel() + out.numel()),
                       2.0 * x.numel() * c)
        rec = dict(shape=f"({n_cl},{d},{m_rows})@({n_cl},{m_rows},{c})",
                   ms=ms, device_ms=dev, plain_ms=plain, bound_ms=bb,
                   bound_by=by, path="colsum")
        ck.rows.append(dict(kernel="modmatmul_batched",
                            what=f"X^T y (setup) C={c}", **rec))
        rows.setdefault("modmatmul_batched", rec)
        del y, out
    del x
    torch.cuda.empty_cache()
    for label, (a, b) in {
            "LCC encode model (per iteration)": (
                ck.field(n_cl, kk + t)[None].expand(n_cl, n_cl, kk + t),
                ck.field(n_cl, kk + t, d)),
            "decode base (per iteration)": (
                ck.field(n_cl)[None, None].expand(n_cl, 1, n_cl),
                ck.field(n_cl, n_cl, d))}.items():
        ck.compare("modmatmul_batched", mm.modmatmul_batched(a, b),
                   ref.modmatmul_batched(a.cpu(), b.cpu()), label)
        ms_ = ck.time_ms(lambda: mm.modmatmul_batched(a, b), 20)
        dev_ = device_ms(torch, lambda: mm.modmatmul_batched(a, b), 20)
        pl_ = ck.time_ms(lambda: ref.modmatmul_batched(a, b), 3)
        bb_, _ = bound(4.0 * (a[0].numel() + b.numel() + b.shape[0]
                              * a.shape[1] * b.shape[2]),
                       2.0 * b.shape[0] * a.shape[1] * b.shape[1] * b.shape[2])
        ck.rows.append(dict(kernel="modmatmul_batched", what=label,
                            shape=f"{tuple(a.shape)}@{tuple(b.shape)}",
                            ms=ms_, device_ms=dev_, plain_ms=pl_,
                            bound_ms=bb_))

    # fused step at cifar10_case2 (C=1) and mnist10_like (N=13, C=10)
    for label, (n, m, dd, c) in {"cifar10_case2": (n_cl, mk, d, 1),
                                 "cifar10_case2 C=10": (n_cl, mk, d, 10),
                                 "mnist10_like": (13, 98, 24, 10)}.items():
        ops_ = fused_operands(ck, n, m, dd, c, 1)
        got = fs.fused_step(*ops_["args"], **ops_["kw"])
        want = ref.fused_step(*[q.cpu() for q in ops_["args"]], **ops_["kw"])
        for g, w_, what in zip(got, want, ("f", "new_w")):
            ck.compare("fused_step", g, w_, f"{label} {what}")
        ms_ = ck.time_ms(lambda: fs.fused_step(*ops_["args"], **ops_["kw"]),
                         20)
        pl_ = ck.time_ms(lambda: ref.fused_step(*ops_["args"], **ops_["kw"]),
                         2)
        nbytes = 4.0 * (n * m * dd + 7 * n * dd * c + 3 * n + 2)
        bb_, by_ = bound(nbytes, 4.0 * n * m * dd * c)
        dev_ = device_ms(torch, lambda: fs.fused_step(*ops_["args"],
                                                      **ops_["kw"]), 20)
        rec = dict(shape=f"N={n} m={m} d={dd} C={c}", ms=ms_, plain_ms=pl_,
                   bound_ms=bb_, bound_by=by_, device_ms=dev_,
                   plan=grad_label(n, m, dd, c))
        ck.rows.append(dict(kernel="fused_step", what=label, **rec))
        if label == "cifar10_case2":
            rows["fused_step"] = rec
        del ops_
    torch.cuda.empty_cache()
    log(f"kernels: main-path checks passed {dict(ck.checks)}")
    return rows


def profile_steps(torch, step, state) -> tuple:
    """Two more steps `state = step(key, state)` (e.g. a protocol's
    iteration) from `state` under torch.profiler: wall and device ms per
    step, the device's idle share and its kernels per step, and the table
    of device time by kernel."""
    from repro_torch.core import random as jrandom
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2):
            state = step(jrandom.fold_in(jrandom.PRNGKey(1), t), state)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    # device-side events only (kernels, memcpys): host ops also report the
    # device time of the kernels they launched
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    kernel_launches = sum(e.count for e in on_device)
    return dict(wall_ms_per_step=prof_wall_ms / 2,
                device_ms_per_step=device_ms / 2,
                idle_share=1.0 - device_ms / prof_wall_ms,
                device_kernels_per_step=kernel_launches / 2), table


def fused_operands(ck: Checker, n, m, d, c, degree) -> dict:
    from repro_torch.core import field
    args = (ck.field(n, m, d), ck.field(n, d, c), ck.field(degree + 1),
            ck.field(n), ck.field(n), ck.field(n), ck.field(n, d, c),
            ck.field(n, d, c), ck.field(n, d, c), ck.field(n, d, c),
            ck.field(n, d, c))
    return {"args": args,
            "kw": dict(q_eta=int(ck.rng.integers(1, ck.P)),
                       inv2k1=field.host_inv(1 << 18), k1=18)}


class ShapeLog:
    """Counts every field-GEMM call of a fit by (phase, op, shapes,
    strides); the phase is "setup" inside `owner`.setup (Copml's by
    default; None: no setup phase) and "step" after."""

    OPS = ("modmatmul", "modmatmul_batched")

    def __init__(self, owner="copml"):
        self.calls: collections.Counter = collections.Counter()
        self.phase = "step"
        self.owner = owner

    def __enter__(self):
        from repro_torch.core import baselines, protocol
        from repro_torch.kernels import ops
        self._ops = ops
        self._cls = {"copml": protocol.Copml,
                     "mpc_baseline": baselines.MpcBaseline,
                     None: None}[self.owner]
        self._real = {name: getattr(ops, name) for name in self.OPS}

        def spy(name):
            def call(a, b):
                self.calls[(self.phase, name, tuple(a.shape), a.stride(),
                            tuple(b.shape), b.stride())] += 1
                return self._real[name](a, b)
            return call

        for name in self.OPS:
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
        for name in self.OPS:
            setattr(self._ops, name, self._real[name])
        if self._cls is not None:
            self._cls.setup = self._setup


GEMM_TIMES: dict = {}          # (op, shapes, strides) -> (device ms, bound)


def gemm_table(ck: Checker, shape_log: ShapeLog, iters: int) -> list:
    """Every GEMM shape of a fit with its launches (setup; per step scaled
    to a 50-iteration fit), path, device time, bound and the time lost
    against the bound in a 50-iteration fit; each shape is checked against
    the plain version on a column slice."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels.plan import gemm_path
    rows = []
    for key, count in sorted(shape_log.calls.items(), key=str):
        phase, name, ash, ast, bsh, bst = key
        if name == "modmatmul":
            bsz, (m_, k_), n_ = 1, ash, bsh[1]
        else:
            (bsz, m_, k_), n_ = ash, bsh[2]
        path = gemm_path(m_, k_, bst[-1], n_, ast[-2], ast[-1])
        if key[1:] not in GEMM_TIMES:
            a, abase = strided_field(ck, ash, ast)
            b, bbase = strided_field(ck, bsh, bst)
            fn = getattr(mm, name)
            out = fn(a, b)
            ck.compare(name, out[..., :2048],
                       getattr(ref, name)(a.cpu(), b[..., :2048].cpu()),
                       f"{phase} {path} {ash}@{bsh}")
            reps = 3 if out.numel() > 50_000_000 else 30
            dev = device_ms(torch, lambda: fn(a, b), reps)
            # only where the profiler failed: CUDA events, wrapper included
            events = ck.time_ms(lambda: fn(a, b), reps) if dev is None \
                else None
            bb, by = bound(4.0 * (abase.numel() + bbase.numel() + out.numel()),
                           2.0 * bsz * m_ * k_ * n_)
            GEMM_TIMES[key[1:]] = (dev, events, bb, by)
            del a, b, abase, bbase, out
            torch.cuda.empty_cache()
        dev, events, bb, by = GEMM_TIMES[key[1:]]
        per_fit = count if phase == "setup" else count / iters * 50
        rows.append(dict(phase=phase, kernel=name, path=path,
                         shape=f"{ash}@{bsh}", k=k_, b_stride=list(bst),
                         launches=count, launches_50_iter_fit=per_fit,
                         device_ms=dev, events_ms=events, bound_ms=bb,
                         bound_by=by, lost_ms_50_iter_fit=None if dev is None
                         else per_fit * (dev - bb)))
    return rows


def no_tiled_gemm(rows: list, run: str = "copml") -> None:
    """No GEMM of a full-width run takes the tiled kernel.  copml: X^T y
    (K = m = 9019, past the thin kernel's 64) takes the column-sum kernel,
    every other the thin one; mpc_baseline: Z = X W (its (N_g, m/3, d)
    shares K-contiguous, N = C) the row-dot kernel, X^T ghat the column-sum
    kernel, the rest the thin one; serving: the scores the split-K kernel,
    the opens the thin one; secure_agg: the thin one."""
    allowed = {"copml": ("thin", "colsum"),
               "mpc_baseline": ("thin", "colsum", "rowdot"),
               "serve": ("thin", "splitk"), "secure_agg": ("thin",)}[run]
    for r in rows:
        assert r["path"] in allowed, (run, r)
        if run == "copml":
            want = "colsum" if r["k"] > 64 else "thin"
            assert r["path"] == want, r


def log_gemm_table(what: str, rows: list) -> None:
    for r in rows:
        if r["device_ms"] is None:
            took = f"device not measured, events {r['events_ms']:.4f} ms"
            lost = "not measured"
        else:
            took = f"{r['device_ms']:.4f} ms"
            lost = f"{r['lost_ms_50_iter_fit']:.3f} ms"
        log(f"  {what} {r['phase']:5s} {r['kernel']:17s} {r['path']:5s} "
            f"{r['shape']:40s} x{r['launches']:<3d} {took} "
            f"(bound {r['bound_ms']:.4f}) lost/50-iter fit {lost}")


def phase_golden(np) -> None:
    from repro_torch import api
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cuda")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert sha(res.state.w_shares.cpu().numpy(), np.int32) == \
        GOLDEN_SHARES_SHA, "smoke shares sha"
    assert sha(res.history, np.float32) == GOLDEN_HIST_SHA, "smoke history"
    for (wl, iters), (s_sha, h_sha) in PINNED.items():
        r = api.fit(wl, "copml", "jit", key=0, iters=iters, device="cuda")
        assert sha(r.state.w_shares.cpu().numpy(), np.int32) == s_sha, wl
        assert sha(r.history, np.float32) == h_sha, wl
    log("golden: smoke goldens and pinned shas reproduced on cuda")


def phase_full(ck: Checker, np) -> tuple:
    """cifar10_case2 at full width; returns (launch counts, summary)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ops, ref

    last = {}
    launch_fused = ops.fused_step

    def capture(*args, **kw):
        last["args"], last["kw"] = args, kw
        return launch_fused(*args, **kw)

    ops.fused_step = capture
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wl = api.get_workload("cifar10_case2")
    wl.client_data()                       # dataset build is set-up
    iters = 5
    ops.reset_launches()
    with ShapeLog() as shapes:
        t0 = time.perf_counter()
        res = api.fit(wl, "copml", "jit", iters=iters, device="cuda")
        wall = time.perf_counter() - t0
    counts = run_counts()
    ops.fused_step = launch_fused
    peak = torch.cuda.max_memory_allocated()

    w = np.asarray(res.weights)
    assert w.shape == (wl.d,) and np.isfinite(w).all(), w.shape
    assert res.history.shape == (iters, wl.d), res.history.shape
    assert counts["fused_step"] == iters, counts
    for name in FUSED_PATH:
        assert counts[name] > 0, f"{name} was not launched on the main path"
    # the last step's operands, held against the plain version on the CPU
    args, kw = last["args"], last["kw"]
    got = fs.fused_step(*args, **kw)
    want = ref.fused_step(*[a.cpu() for a in args], **kw)
    for g, w_, what in zip(got, want, ("f", "new_w")):
        ck.compare("fused_step", g, w_, f"cifar10_case2 last step {what}")
    assert res.final_accuracy > 0.5, res.final_accuracy

    # a profile of two more steps from the final state: device time by kernel
    proto = api.protocols.driver(wl, torch.device("cuda"))
    profiled, table = profile_steps(torch, proto.iteration, res.state)
    gemms = gemm_table(ck, shapes, iters)
    log_gemm_table("fused", gemms)
    no_tiled_gemm(gemms)
    thin = [r for r in gemms if r["path"] == "thin"]
    assert {r["phase"] for r in thin} == {"setup", "step"}, gemms

    summary = dict(workload=wl.name, n=wl.n_clients, m=wl.m, d=wl.d,
                   k=wl.cfg.k, t=wl.cfg.t, iters=iters, wall_s=wall,
                   setup_s=res.timings["setup_s"],
                   ms_per_iter=res.timings["iters_s"] / iters * 1e3,
                   peak_gib=peak / 2 ** 30,
                   final_accuracy=res.final_accuracy,
                   accuracy=[float(a) for a in res.accuracy],
                   launches=counts, profiled_steps=profiled, profile=table,
                   gemm_shapes=gemms)
    log(f"full: {wl.name} N={wl.n_clients} m={wl.m} d={wl.d} "
        f"setup {summary['setup_s']:.3f} s, {summary['ms_per_iter']:.3f} "
        f"ms/iter, peak {summary['peak_gib']:.2f} GiB, accuracy "
        f"{res.final_accuracy:.4f}, launches {counts}")
    log(f"full: profiled steps {summary['profiled_steps']}")
    return counts, summary, res

def phase_kernels_siloed(ck: Checker, quick: bool) -> dict:
    """The coded-gradient and poly_eval kernels against their plain
    versions (CPU copies, exact) at ragged and main-path shapes, timed."""
    torch = ck.torch
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import field_poly as fp
    from repro_torch.kernels import ref

    def check_cg(label, n, m, d, c, degree, offset=0, worst=False):
        x = ck.field(offset + n * m * d)[offset:].view(n, m, d)
        w, co = ck.field(n, d, c), ck.field(degree + 1)
        if worst:                          # every product near 2^52
            x.fill_(ck.P - 1)
            w.fill_(ck.P - 1)
        label = f"{label} {grad_label(n, m, d, c)}"
        want = ref.coded_gradient_matrix(x.cpu(), w.cpu(), co.cpu())
        ck.compare("coded_gradient_matrix", cg.coded_gradient_matrix(x, w, co),
                   want, label)
        if c == 1:
            ck.compare("coded_gradient_batched",
                       cg.coded_gradient_batched(x, w[..., 0], co),
                       want[..., 0], label)
            ck.compare("coded_gradient",
                       cg.coded_gradient(x[0], w[0, :, 0], co),
                       want[0, :, 0], label)
        return x, w, co

    # -- ragged shapes: m not a multiple of the slice height, d in
    #    {6, 24, 29, 3073, 4000, 40000}, C in {1, 10}, degrees 1 and 3;
    #    the three accumulator modes, clients 4 bytes off a 16-byte line,
    #    bm = 7 and 3, m below one slice, X~ sizes not a multiple of 16
    #    bytes, and an X~ that starts 4 bytes off (offset 1 word)
    for (n, m, d, c, deg, off) in [
            (3, 13, 6, 1, 1, 0), (5, 13, 24, 10, 3, 0),
            (5, 37, 3073, 1, 3, 0), (2, 130, 3073, 10, 1, 0),
            (1, 1, 6, 1, 1, 0), (4, 2049, 24, 1, 3, 0),
            (3, 37, 29, 1, 1, 0), (4, 45, 4000, 1, 1, 0),
            (2, 19, 3073, 10, 3, 0), (2, 3, 40000, 1, 1, 0),
            (3, 3, 24, 1, 1, 0), (5, 37, 3073, 1, 1, 1),
            (3, 37, 29, 10, 3, 3)]:
        check_cg(f"N={n} m={m} d={d} C={c} degree {deg} offset {off}",
                 n, m, d, c, deg, off)
    # x = w = p - 1 past d = 32768: pass 1's lane sums pass 2^58
    check_cg("N=2 m=3 d=40000 C=1 x = w = p - 1", 2, 3, 40000, 1, 1,
             worst=True)
    # poly_eval: both kernels (one thread an element; grid-stride past
    # one wave of chunks), 2-D, degrees 0 to 63, z 4 bytes off, z = every
    # coefficient = p - 1
    for (shape, deg, off, worst) in [
            ((45,), 1, 0, False), ((7, 13), 3, 0, False),
            ((4099,), 3, 0, False), ((1,), 1, 0, False),
            ((3_000_001,), 7, 0, False), ((5000,), 63, 1, False),
            ((4099,), 0, 0, False), ((2049,), 7, 0, True),
            ((2_500_003,), 63, 1, False), ((2_500_003,), 7, 0, True)]:
        n = 1
        for v in shape:
            n *= v
        z, co = ck.field(off + n)[off:].view(shape), ck.field(deg + 1)
        if worst:
            z.fill_(ck.P - 1)
            co.fill_(ck.P - 1)
        ck.compare("poly_eval", fp.poly_eval(z, co),
                   ref.poly_eval(z.cpu(), co.cpu()),
                   f"{shape} degree {deg} offset {off}"
                   f"{' p - 1' if worst else ''}")
    log(f"kernels: siloed ragged checks passed {dict(ck.checks)}")
    if quick:
        return {}

    # -- main-path shapes: one cifar10_case2 step (N=50, mk=902, d=3073),
    #    its C=10 twin, mnist10_like's matrix step, one client, and the z of
    #    one cifar10_case2 step for poly_eval
    rows = {}
    for name, label, (n, m, d, c) in [
            ("coded_gradient_batched", "cifar10_case2", (50, 902, 3073, 1)),
            ("coded_gradient_matrix", "cifar10_case2 C=10",
             (50, 902, 3073, 10)),
            ("coded_gradient_matrix", "mnist10_like", (13, 98, 24, 10)),
            ("coded_gradient", "one cifar10_case2 client",
             (1, 902, 3073, 1))]:
        x, w, co = check_cg(label, n, m, d, c, 1)
        if name == "coded_gradient_batched":
            args = (x, w[..., 0], co)
        elif name == "coded_gradient":
            args = (x[0], w[0, :, 0], co)
        else:
            args = (x, w, co)
        ms_ = ck.time_ms(lambda: getattr(cg, name)(*args), 20)
        pl_ = ck.time_ms(lambda: getattr(ref, name)(*args), 2)
        bb_, by_ = bound(4.0 * (n * m * d + 2 * n * d * c + 2),
                         4.0 * n * m * d * c)
        dev_ = device_ms(torch, lambda: getattr(cg, name)(*args), 20)
        rec = dict(shape=f"N={n} m={m} d={d} C={c}", ms=ms_, plain_ms=pl_,
                   bound_ms=bb_, bound_by=by_, device_ms=dev_,
                   plan=grad_label(n, m, d, c))
        ck.rows.append(dict(kernel=name, what=label, **rec))
        rows.setdefault(name, rec)
        del x, w, co, args
    torch.cuda.empty_cache()
    # poly_eval: the z of one cifar10_case2 step (a launch's floor) and
    # 2^26 elements (512 MB, bytes-bound), at COPML's degree r = 1 and 7
    for label, length, deg in [("z of one cifar10_case2 step", 50 * 902, 1),
                               ("z of one cifar10_case2 step", 50 * 902, 7),
                               ("2^26", 1 << 26, 1), ("2^26", 1 << 26, 7),
                               ("ragged", 1_000_003, 3)]:
        z, co = ck.field(length), ck.field(deg + 1)
        ck.compare("poly_eval", fp.poly_eval(z, co),
                   ref.poly_eval(z.cpu(), co.cpu()), f"{label} degree {deg}")
        reps = 50 if length < 1 << 20 else 20
        ms_ = ck.time_ms(lambda: fp.poly_eval(z, co), reps)
        dev_ = device_ms(torch, lambda: fp.poly_eval(z, co), reps)
        pl_ = ck.time_ms(lambda: ref.poly_eval(z, co), 5)
        bb_, by_ = bound(8.0 * length, 2.0 * deg * length)
        rec = dict(shape=f"L={length} degree {deg}", ms=ms_, device_ms=dev_,
                   plain_ms=pl_, bound_ms=bb_, bound_by=by_)
        ck.rows.append(dict(kernel="poly_eval", what=label, **rec))
        rows.setdefault("poly_eval", rec)
        del z, co
    log(f"kernels: siloed main-path checks passed {dict(ck.checks)}")
    return rows


def phase_kernels_protocols(ck: Checker, quick: bool) -> dict:
    """The row-dot and split-K GEMMs at the shapes the other paths give
    them, against the plain version (CPU copies, exact), timed by device
    time with their bound: the MPC baseline's Z = X W, a K-contiguous (N_g,
    m/3, d) share tensor times (N_g, d, C) at cifar10_case2 (16, 3006,
    3073) with C = 1 and 10, on the row-dot kernel, and serving's packed
    (B, d) @ (d, N) (the row-major w_cols) at B in SERVE_BATCHES, on the
    split-K kernel.  --quick checks cuts of both shapes only.  Returns the
    kernels line's rows of the two paths (Z at C = 1, serving at batch 1)."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref
    ng, mg, d, n_cl = (3, 301, 3073, 50) if quick else (16, 3006, 3073, 50)
    rows = {}
    for c in (1, 10):
        x, w = ck.field(ng, mg, d), ck.field(ng, d, c)
        assert mm.path_of(x, w) == "rowdot", (x.shape, w.shape)
        ck.compare("modmatmul_batched.rowdot", mm.modmatmul_batched(x, w),
                   ref.modmatmul_batched(x.cpu(), w.cpu()),
                   f"rowdot MPC baseline Z ({ng},{mg},{d})@({ng},{d},{c})")
        if not quick:
            fn = (lambda a, b: lambda: mm.modmatmul_batched(a, b))(x, w)
            bb, by = bound(4.0 * (x.numel() + w.numel() + ng * mg * c),
                           2.0 * x.numel() * c)
            rec = dict(shape=f"({ng},{mg},{d})@({ng},{d},{c})",
                       ms=ck.time_ms(fn, 10),
                       device_ms=device_ms(torch, fn, 10),
                       plain_ms=ck.time_ms(
                           lambda: ref.modmatmul_batched(x, w), 1),
                       bound_ms=bb, bound_by=by, path="rowdot")
            ck.rows.append(dict(
                kernel="modmatmul_batched",
                what=f"MPC baseline Z = X W C={c} (per group, per step)",
                **rec))
            rows.setdefault("modmatmul_batched.rowdot", rec)
        del x, w
    torch.cuda.empty_cache()
    for b in SERVE_BATCHES:
        a, w = ck.field(b, d), ck.field(d, n_cl)
        assert mm.path_of(a[None], w[None]) == "splitk"
        ck.compare("modmatmul.splitk", mm.modmatmul(a, w),
                   ref.modmatmul(a.cpu(), w.cpu()),
                   f"splitk serving ({b},{d})@({d},{n_cl})")
        if not quick:
            fn = (lambda a_, w_: lambda: mm.modmatmul(a_, w_))(a, w)
            bb, by = bound(4.0 * (a.numel() + w.numel() + b * n_cl),
                           2.0 * b * d * n_cl)
            rec = dict(shape=f"({b},{d})@({d},{n_cl})",
                       ms=ck.time_ms(fn, 50),
                       device_ms=device_ms(torch, fn, 50),
                       plain_ms=ck.time_ms(lambda: ref.modmatmul(a, w), 3),
                       bound_ms=bb, bound_by=by, path="splitk")
            ck.rows.append(dict(kernel="modmatmul",
                                what=f"serving score GEMM, batch {b}", **rec))
            rows.setdefault("modmatmul.splitk", rec)
    log(f"kernels: row-dot and split-K GEMM checks at the MPC baseline's "
        f"and serving's shapes passed {dict(ck.checks)}")
    return rows


def phase_kernels_proc(ck: Checker, quick: bool) -> dict:
    """The kernels at the shapes a proc:4 worker gives them (one rank's
    n_loc = 13 clients of cifar10_case2, the last rank's 2 of them zero
    rows; one rank's 4 clients of mnist10_like, 3 of them zero rows):
    coded_gradient_batched (13, 902, 3073), coded_gradient_matrix (4, 98,
    24, 10), and every field GEMM of a worker's step with the strides the
    worker passes (worker.step_gemms), each against its plain version (CPU
    copies, exact) and timed by device time with its bound.  Returns the
    kernels line's "proc worker" shapes by kernel."""
    torch = ck.torch
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref
    from repro_torch.launch.runtime import worker
    if quick:
        return {}
    rows = {}
    for name, (n, m, d, c, real) in {
            "coded_gradient_batched": (13, 902, 3073, 1, 11),
            "coded_gradient_matrix": (4, 98, 24, 10, 1)}.items():
        x, w, co = ck.field(n, m, d), ck.field(n, d, c), ck.field(2)
        x[real:] = 0                      # the zero-padded clients
        w[real:] = 0
        args = (x, w[..., 0], co) if c == 1 else (x, w, co)
        fn = (lambda f, a: lambda: f(*a))(getattr(cg, name), args)
        ck.compare(name, fn(), getattr(ref, name)(*[a.cpu() for a in args]),
                   f"proc worker N={n} ({real} real) m={m} d={d} C={c}")
        bb, by = bound(4.0 * (n * m * d + 2 * n * d * c + 2),
                       4.0 * n * m * d * c)
        rec = dict(shape=f"N={n} ({real} real) m={m} d={d} C={c}",
                   ms=ck.time_ms(fn, 20), device_ms=device_ms(torch, fn, 20),
                   plain_ms=ck.time_ms(
                       lambda: getattr(ref, name)(*args), 2),
                   bound_ms=bb, bound_by=by, plan=grad_label(n, m, d, c))
        ck.rows.append(dict(kernel=name, what="proc:4 worker step", **rec))
        rows[name] = rec
        del x, w, co, args, fn
    gemms = worker.step_gemms(50, 10, 7, 3073, 4, 49)
    for (name, ash, ast, bsh, bst), count in sorted(gemms.items()):
        a, abase = strided_field(ck, ash, ast)
        b, bbase = strided_field(ck, bsh, bst)
        path = mm.path_of(*((a[None], b[None]) if name == "modmatmul"
                            else (a, b)))
        assert path == "thin", (name, ash, bsh, path)
        fn = (lambda f, a_, b_: lambda: f(a_, b_))(getattr(mm, name), a, b)
        out = fn()
        ck.compare(name, out[..., :2048],
                   getattr(ref, name)(a.cpu(), b[..., :2048].cpu()),
                   f"proc worker {path} {ash}@{bsh} strides {ast} {bst}")
        bsz, (m_, k_), n_ = ((1, ash, bsh[1]) if name == "modmatmul"
                             else (ash[0], ash[1:], bsh[2]))
        bb, by = bound(4.0 * (min(a.numel(), abase.numel())
                              + min(b.numel(), bbase.numel()) + out.numel()),
                       2.0 * bsz * m_ * k_ * n_)
        rec = dict(shape=f"{ash}@{bsh} strides {ast} {bst}", path=path,
                   launches_per_step=count, ms=ck.time_ms(fn, 30),
                   device_ms=device_ms(torch, fn, 30),
                   plain_ms=ck.time_ms(
                       lambda: getattr(ref, name)(a, b), 2),
                   bound_ms=bb, bound_by=by)
        ck.rows.append(dict(kernel=name, what="proc:4 worker step", **rec))
        log(f"  proc worker {name:17s} {rec['shape']:60s} x{count}/step "
            f"{rec['device_ms']} ms (bound {bb:.4f})")
        del a, b, abase, bbase, out, fn
    torch.cuda.empty_cache()
    log(f"kernels: the proc:4 workers' shapes passed {dict(ck.checks)}")
    return rows


def phase_golden_protocols(np) -> None:
    """The pinned MPC baseline (bh08, bgw) and aggregation-round shas on
    the card, and smoke serving bit-exact against reference_scores."""
    import torch
    from repro_torch import api
    from repro_torch.serve import coded
    cuda = torch.device("cuda")
    for scheme, want in MPC_SHAS.items():
        got = mpc_smoke(scheme, cuda)
        assert got == want, (scheme, got)
    assert agg_rounds(cuda) == AGG_SHAS, "aggregation round shas"
    wl = api.get_workload("smoke")
    x = np.asarray(wl.eval_set()[0], np.float32)
    for protocol in ("copml", "float"):
        res = api.fit(wl, protocol, "jit", key=0, iters=10, device="cuda")
        srv = api.serve(wl, res, "jit", batch_size=32, device="cuda")
        assert srv.model.from_shares == (protocol == "copml")
        np.testing.assert_array_equal(
            srv.score_field(x),
            coded.reference_scores(res.weights, x, wl.cfg).numpy())
    log("golden: the MPC baseline (bh08, bgw) and aggregation-round shas "
        "reproduced on cuda; smoke serving equals reference_scores")


def fit_protocol(ck: Checker, protocol: str, engine: str = "jit",
                 shape_log=None) -> tuple:
    """api.fit(FULL_WORKLOAD, protocol, engine, iters=FULL_ITERS) on the
    card with the launch counts reset just before and read just after.
    Returns (result, counts, peak bytes above the fit's start)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import ops
    wl = api.get_workload(FULL_WORKLOAD)
    wl.client_data()                       # dataset build is set-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    if shape_log is None:
        res = api.fit(wl, protocol, engine, key=0, iters=FULL_ITERS,
                      device="cuda")
    else:
        with shape_log:
            res = api.fit(wl, protocol, engine, key=0, iters=FULL_ITERS,
                          device="cuda")
    counts = run_counts()
    return res, counts, torch.cuda.max_memory_allocated() - held


def protocol_stepper(torch, protocol: str, res):
    """(step(key, state), state): one more training step of a finished
    full-width fit, for profile_steps."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import baselines, secure_agg, sigmoid_approx
    wl = api.get_workload(FULL_WORKLOAD)
    cuda = torch.device("cuda")
    if protocol == "mpc_baseline":
        return api.protocols.get(protocol).driver(wl, cuda).iteration, \
            res.state
    w = torch.from_numpy(np.asarray(res.weights, np.float32)).to(cuda)
    if protocol == "secure_agg":
        xs, ys, mask = secure_agg._padded_clients(*wl.client_data(),
                                                  wl.objective, cuda)
        return (lambda key, w_: secure_agg.secure_step(
            key, xs, ys, mask, w_, res.state, wl.cfg.eta,
            objective=wl.objective)), w
    x, y, _, _ = wl.data()
    x = baselines.to_device(x, torch.float32, cuda)
    y = baselines.to_device(y, torch.float32, cuda)
    ghat = torch.sigmoid
    if protocol == "poly_float":
        coeffs = sigmoid_approx.fit_sigmoid_poly(wl.cfg.r,
                                                 wl.cfg.sigmoid_bound)
        ghat = (lambda z: baselines.horner(coeffs, z))
    return (lambda key, w_: baselines.gd(x, y, w_, wl.cfg.eta, 1, ghat)), w


def phase_protocols(ck: Checker, np, fused_summary: dict) -> tuple:
    """mpc_baseline, secure_agg, float and poly_float at full width
    (FULL_WORKLOAD, FULL_ITERS): each fit's counts reset just before it and
    read just after; setup s, ms/iter, peak memory, a profile of two more
    steps, accuracy; the GEMMs of mpc_baseline and secure_agg by shape and
    path (the baseline's Z = X W on the row-dot kernel, none on the tiled
    one).  Returns ({protocol: summary}, {protocol: counts}, the float result)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.core import cost_model
    wl = api.get_workload(FULL_WORKLOAD)
    out, counts_by, float_res = {}, {}, None
    for protocol, path in PROTOCOL_PATHS.items():
        shapes = None
        if protocol in ("mpc_baseline", "secure_agg"):
            shapes = ShapeLog(protocol if protocol == "mpc_baseline"
                              else None)
        res, counts, peak = fit_protocol(ck, protocol, shape_log=shapes)
        for name in path:
            assert counts[name] > 0, \
                f"{name} was not launched on the {protocol} path"
        if not path:
            assert not any(counts.values()), (protocol, counts)
        w = np.asarray(res.weights)
        assert w.shape == (wl.d,) and np.isfinite(w).all(), protocol
        assert res.history.shape == (FULL_ITERS, wl.d), protocol
        assert res.final_accuracy > 0.5, (protocol, res.final_accuracy)
        summary = run_summary(res, counts, peak)
        step, state = protocol_stepper(torch, protocol, res)
        summary["profiled_steps"], summary["profile"] = profile_steps(
            torch, step, state)
        del step, state
        if shapes is not None:
            summary["gemm_shapes"] = gemm_table(ck, shapes, FULL_ITERS)
            log_gemm_table(protocol, summary["gemm_shapes"])
            no_tiled_gemm(summary["gemm_shapes"], protocol)
            if protocol == "mpc_baseline":      # Z = X W on the row-dot path
                rowdot = [r for r in summary["gemm_shapes"]
                          if r["path"] == "rowdot"]
                assert rowdot and all(r["kernel"] == "modmatmul_batched"
                                      and r["phase"] == "step"
                                      and r["k"] == wl.d for r in rowdot), \
                    rowdot
        if protocol == "float":
            float_res = res
            # full width: float32 (jit) within 1e-3 of float64 (eager)
            eager, _, _ = fit_protocol(ck, protocol, "eager")
            gap = float(np.abs(eager.weights - w).max())
            assert gap < 1e-3, gap
            summary["eager_vs_jit_max_abs"] = gap
        else:
            res.state = None
        prof = summary["profiled_steps"]
        log(f"protocols: {protocol} {wl.name} setup "
            f"{summary['setup_s']:.3f} s, {summary['ms_per_iter']:.3f} "
            f"ms/iter, peak {summary['peak_gib']:.2f} GiB, device "
            f"{prof['device_ms_per_step']:.4f} ms/step, idle "
            f"{prof['idle_share']:.1%}, kernels/step "
            f"{prof['device_kernels_per_step']:.1f}, accuracy "
            f"{res.final_accuracy:.4f}, launches {counts}")
        out[protocol] = summary
        counts_by[protocol] = counts
    cw = cost_model.Workload(m=wl.m, d=wl.d, n=wl.n_clients, k=wl.cfg.k,
                             t=wl.cfg.t, iters=FULL_ITERS, r=wl.cfg.r)
    modelled = {s: cost_model.speedup(cw, scheme=s) for s in ("bh08", "bgw")}
    copml_dev = fused_summary["profiled_steps"]["device_ms_per_step"]
    mpc_dev = out["mpc_baseline"]["profiled_steps"]["device_ms_per_step"]
    out["simulated_compute"] = dict(
        copml_device_ms_per_step=copml_dev,
        mpc_baseline_device_ms_per_step=mpc_dev,
        ratio=mpc_dev / copml_dev, modelled_speedup=modelled)
    log(f"protocols: single-card simulated compute, device ms per step: "
        f"copml {copml_dev:.4f}, mpc_baseline {mpc_dev:.4f} "
        f"({mpc_dev / copml_dev:.2f}x); cost_model's MODELLED WAN speedup "
        f"at {FULL_ITERS} iterations: bh08 {modelled['bh08']:.2f}x, bgw "
        f"{modelled['bgw']:.2f}x")
    return out, counts_by, float_res


def phase_serve(ck: Checker, np, copml_res, float_res) -> tuple:
    """api.serve on the full-width copml result (re-shared, never opened):
    SERVE_QUERIES eval queries at each of SERVE_BATCHES, every window's
    score_field equal to reference_scores of the opened model (computed on
    the card and on the CPU) bit for bit; queries/s, encode s, and the
    device time of one window.  The float result (fallback encode) at the
    largest batch.  Returns (summary, launch counts of the serve runs)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.serve import coded
    wl = api.get_workload(FULL_WORKLOAD)
    q = np.asarray(wl.eval_set()[0][:SERVE_QUERIES], np.float32)
    out = {}
    counts = collections.Counter()
    for label, res, batches in (("copml", copml_res, SERVE_BATCHES),
                                ("float", float_res, SERVE_BATCHES[-1:])):
        want = coded.reference_scores(res.weights, q, wl.cfg, device="cpu")
        on_card = coded.reference_scores(res.weights, q, wl.cfg,
                                         device="cuda")
        ck.compare("modmatmul", on_card, want,
                   f"{label} reference_scores on the card")
        want = want.numpy()
        for b in batches:
            srv = api.serve(wl, res, "jit", batch_size=b, device="cuda")
            assert srv.model.from_shares == (label == "copml")
            got = np.concatenate([srv.score_field(q[i:i + b])
                                  for i in range(0, len(q), b)])
            np.testing.assert_array_equal(got, want, err_msg=f"{label} {b}")
            shapes = ShapeLog(None)
            ops.reset_launches()
            with shapes:
                preds, stats = srv.serve(q)
            run = run_counts()
            for name in SERVE_PATH:
                assert run[name] > 0, f"{name} not launched serving"
            assert run["gemm:splitk"] == stats["batches"], run
            counts.update(run)
            # 50 "iterations": the per-fit columns read per 1024 queries
            gemms = gemm_table(ck, shapes, 50)
            log_gemm_table(f"serve {label} {b}", gemms)
            no_tiled_gemm(gemms, "serve")
            np.testing.assert_array_equal(      # the sign of each logit
                preds, (np.where(want > ck.P // 2, want - ck.P, want)[:, 0]
                        > 0).astype(np.int32))
            xb = torch.from_numpy(q[:b]).cuda()
            window = device_ms(torch, lambda: srv._score(xb), 20)
            out[f"{label} batch {b}"] = dict(
                queries_per_s=stats["queries_per_s"], serve_s=stats["serve_s"],
                encode_s=stats["encode_s"], batches=stats["batches"],
                device_ms_per_window=window, launches=run,
                gemm_shapes=gemms)
            log(f"serve: {label} {wl.name} batch {b}: "
                f"{stats['queries_per_s']:.0f} queries/s over "
                f"{stats['queries']} queries, encode "
                f"{stats['encode_s']:.4f} s, device "
                f"{'not measured' if window is None else f'{window:.4f} ms'}"
                f" per window, launches {run}")
            del srv
    log("serve: every window's field logits equal reference_scores of the "
        "opened model, bit for bit, on the card")
    return out, dict(counts)



def proc_counts(coord: dict, mc: dict) -> dict:
    """Launches of a proc run, run_counts' keys: the coordinator's (its
    setup and openings) plus every worker's."""
    total = dict(coord)
    for rec in mc["workers"]:
        for name, c in rec["launches"].items():
            total[name] += c
        for path, c in rec["gemm_paths"].items():
            total[f"gemm:{path}"] += c
    return total


def proc_workers_ok(mc: dict, iters: int, kernel: str) -> None:
    """Every worker ran on the card, launched `kernel` (its coded
    gradient) once a step and fused_step never, and took no GEMM down the
    tiled path; its GEMMs by path add up to its GEMMs by shape."""
    for rank, rec in enumerate(mc["workers"]):
        assert rec["device"].startswith("cuda"), (rank, rec["device"])
        assert rec["launches"][kernel] == iters, (rank, rec["launches"])
        assert rec["launches"]["fused_step"] == 0, (rank, rec["launches"])
        assert rec["gemm_paths"]["tiled"] == 0, (rank, rec["gemm_paths"])
        assert sum(rec["gemm_paths"].values()) == \
            sum(g[5] for g in rec["gemms"]), (rank, rec)


def fit_proc(ck: Checker, workload, engine, iters: int, **kw) -> tuple:
    """api.fit(workload, "copml", engine) on the card with the launch
    counts reset just before and read just after (the coordinator's plus
    every worker's); returns (result, counts, coordinator peak bytes above
    what was held when it started)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    res = api.fit(workload, "copml", engine, key=0, iters=iters,
                  device="cuda", **kw)
    counts = proc_counts(run_counts(), res.measured_comm)
    return res, counts, torch.cuda.max_memory_allocated() - held


def modelled_comm(wl, iters: int) -> dict:
    """cost_model.copml_costs' per-client communication for the run, and
    the bytes it implies for all N clients at 4 bytes an element (the
    WAN model: the dataset's coded slices, then 2 d C N elements a step)."""
    from repro_torch.core import cost_model
    cw = cost_model.Workload(m=wl.m, d=wl.d, n=wl.n_clients, k=wl.cfg.k,
                             t=wl.cfg.t, iters=iters, r=wl.cfg.r,
                             c=wl.objective.n_outputs)
    setup = wl.m * wl.d * wl.n_clients / wl.cfg.k
    per_step = 2 * wl.d * wl.objective.n_outputs * wl.n_clients
    return dict(comm_s=cost_model.copml_costs(cw)["comm_s"],
                setup_mb=4 * setup * wl.n_clients / 1e6,
                per_step_mb=4 * per_step * wl.n_clients / 1e6)


def phase_proc(ck: Checker, np, fused) -> tuple:
    """The proc:4 engine on the card: FULL_WORKLOAD at full width, bit-equal
    to phase 4's jit fit (same key), with the choreography's frames and
    every worker's launches; a slow-link straggler on smoke_straggler and
    mnist10_like (the matrix kernel in the workers), both bit-equal to
    jit; then the CLI as subprocesses on the card (a fit and serve_main)
    and in-process (its fit lands on GOLDEN_W).  Returns (summary,
    {run: counts})."""
    from repro_torch import api
    from repro_torch.api import cli
    from repro_torch.core import cost_model
    wl = api.get_workload(FULL_WORKLOAD)
    wl.client_data()                       # dataset build is set-up
    res, counts, peak = fit_proc(ck, wl, PROC_ENGINE, FULL_ITERS)
    same_model(np, res, fused, f"{PROC_ENGINE} vs jit full-width run")
    assert sha(res.state.w_shares.cpu().numpy(), np.int32) == \
        sha(fused.state.w_shares.cpu().numpy(), np.int32), "proc shares"
    mc = res.measured_comm
    assert mc["frames_by_phase"] == cost_model.proc_net_frames(
        PROC_N, FULL_ITERS, history=True), mc["frames_by_phase"]
    assert mc["degraded_steps"] == 0 and mc["dropped_frames"] == {}, mc
    proc_workers_ok(mc, FULL_ITERS, "coded_gradient_batched")
    for name in ("modmatmul", "modmatmul_batched", "coded_gradient_batched"):
        assert counts[name] > 0, f"{name} was not launched on the proc path"
    model = modelled_comm(wl, FULL_ITERS)
    summary = dict(run_summary(res, counts, peak),
                   measured={k: v for k, v in mc.items() if k != "workers"},
                   workers=mc["workers"], modelled=model)
    mb = {k: v / 1e6 for k, v in mc["bytes_by_phase"].items()}
    log(f"proc: {wl.name} {PROC_ENGINE} setup_wall_s "
        f"{mc['setup_wall_s']:.3f}, wall_s {mc['wall_s']:.3f}, "
        f"{summary['ms_per_iter']:.3f} ms/iter, coordinator peak "
        f"{summary['peak_gib']:.2f} GiB; measured MB by phase "
        + ", ".join(f"{k} {v:.3f}" for k, v in mb.items())
        + f" (total {mc['total_bytes'] / 1e6:.3f}); s by phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in mc["seconds_by_phase"].items())
        + f"; frames {mc['frames_by_phase']}; modelled (cost_model, WAN, "
        f"4 B an element, all N clients): setup {model['setup_mb']:.1f} MB, "
        f"{model['per_step_mb']:.3f} MB a step, comm "
        f"{model['comm_s']:.1f} s a client; accuracy "
        f"{res.final_accuracy:.4f} (equal to jit's); launches {counts}")
    log("proc: workers " + "; ".join(
        f"rank {r} {w['device']} wall {w['wall_s']:.3f} s launches "
        f"{ {k: v for k, v in w['launches'].items() if v} } paths "
        f"{ {k: v for k, v in w['gemm_paths'].items() if v} }"
        for r, w in enumerate(mc["workers"])))
    res.state = None
    runs = {f"{PROC_ENGINE} {wl.name}": counts}

    ref = api.fit("smoke_straggler", "copml", "jit", key=0, subset="all",
                  history=False, device="cuda")
    slow = api.EngineSpec("proc", devices=PROC_N,
                          net=api.NetConfig(**STRAGGLER_NET))
    sres, _, _ = fit_proc(ck, "smoke_straggler", slow, ref.iters,
                          subset="all", history=False)
    smc = sres.measured_comm
    assert smc["degraded_steps"] >= 1, smc
    assert smc["frames_by_phase"] == cost_model.proc_net_frames(
        PROC_N, ref.iters, history=False)
    np.testing.assert_array_equal(sres.weights, ref.weights)
    np.testing.assert_array_equal(sres.state.w_shares.cpu().numpy(),
                                  ref.state.w_shares.cpu().numpy())
    proc_workers_ok(smc, ref.iters, "coded_gradient_batched")
    summary["straggler"] = {k: v for k, v in smc.items() if k != "workers"}
    log(f"proc: smoke_straggler with rank 3's links 0.35 s slow: "
        f"{smc['degraded_steps']} degraded steps of {ref.iters}, dropped "
        f"{smc['dropped_frames']}, weights and shares equal to jit's, "
        f"wall {smc['wall_s']:.3f} s")

    mref = api.fit("mnist10_like", "copml", "jit", key=0, iters=3,
                   history=False, device="cuda")
    mres, mcounts, _ = fit_proc(ck, "mnist10_like", PROC_ENGINE, 3,
                                history=False)
    np.testing.assert_array_equal(mres.weights, mref.weights)
    np.testing.assert_array_equal(mres.state.w_shares.cpu().numpy(),
                                  mref.state.w_shares.cpu().numpy())
    proc_workers_ok(mres.measured_comm, 3, "coded_gradient_matrix")
    runs[f"{PROC_ENGINE} mnist10_like"] = mcounts
    log(f"proc: mnist10_like {PROC_ENGINE} bit-equal to jit, launches "
        f"{mcounts}")

    got = []
    real_fit = cli.fit
    cli.fit = lambda *a, **k: got.append(real_fit(*a, **k)) or got[-1]
    try:
        cli.main(["smoke", "--iters", "10"])
    finally:
        cli.fit = real_fit
    np.testing.assert_array_equal(np.asarray(got[0].weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert got[0].device.startswith("cuda")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    for args in (["smoke", "--iters", "10"],
                 ["serve", "smoke", "--iters", "10"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.api.cli", *args], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=300,
            check=True).stdout
        for line in out.splitlines():
            log(f"proc: cli {' '.join(args)}: {line}")
        assert "on cuda" in out.splitlines()[0], out
        summary.setdefault("cli", {})[" ".join(args)] = out
    return summary, runs


def set_schedule(mode: str) -> None:
    """REPRO_FUSED_STEP for the next fit ("0" siloed, "1" fused)."""
    os.environ["REPRO_FUSED_STEP"] = mode


def phase_golden_siloed(np) -> None:
    """The goldens and pins on the siloed schedule, and the fault plan's
    shas on both schedules."""
    from repro_torch import api
    set_schedule("0")
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cuda")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert sha(res.state.w_shares.cpu().numpy(), np.int32) == \
        GOLDEN_SHARES_SHA, "siloed smoke shares sha"
    assert sha(res.history, np.float32) == GOLDEN_HIST_SHA, \
        "siloed smoke history"
    for (wl, iters), (s_sha, h_sha) in PINNED.items():
        r = api.fit(wl, "copml", "jit", key=0, iters=iters, device="cuda")
        assert sha(r.state.w_shares.cpu().numpy(), np.int32) == s_sha, wl
        assert sha(r.history, np.float32) == h_sha, wl
    plan = api.FaultPlan.from_schedule(13, 6, **FAULT_SCHEDULE)
    for mode in ("0", "1"):
        set_schedule(mode)
        r = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                    faults=plan, device="cuda")
        got = (sha(r.state.w_shares.cpu().numpy(), np.int32),
               sha(r.history, np.float32))
        assert got == FAULTY_SHAS, (mode, got)
    set_schedule("1")
    log("golden: siloed goldens, pinned shas and the fault plan's shas "
        "(both schedules) reproduced on cuda")


def fit_full(ck: Checker, mode: str, record=(), faults=None,
             workload=None, shape_log=None) -> tuple:
    """api.fit(workload, iters=FULL_ITERS) on the card on schedule `mode`,
    with the launch counts reset just before and read just after; the
    arguments of every call to the ops entries named in `record` are kept.
    Returns (result, counts, calls, peak bytes the fit allocated above what
    was held when it started)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import ops
    calls = {name: [] for name in record}
    real = {name: getattr(ops, name) for name in record}

    def spy(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return real[name](*args, **kw)
        return call

    set_schedule(mode)
    wl = api.get_workload(workload or FULL_WORKLOAD)
    wl.client_data()                       # dataset build is set-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for name in record:
        setattr(ops, name, spy(name))
    try:
        ops.reset_launches()
        if shape_log is None:
            res = api.fit(wl, "copml", "jit", key=0, iters=FULL_ITERS,
                          faults=faults, device="cuda")
        else:
            with shape_log:
                res = api.fit(wl, "copml", "jit", key=0, iters=FULL_ITERS,
                              faults=faults, device="cuda")
        counts = run_counts()
    finally:
        for name in record:
            setattr(ops, name, real[name])
        set_schedule("1")
    return res, counts, calls, torch.cuda.max_memory_allocated() - held


def run_summary(res, counts, peak) -> dict:
    return dict(workload=res.workload, iters=res.iters, wall_s=res.wall_time_s,
                setup_s=res.timings["setup_s"],
                ms_per_iter=res.timings["iters_s"] / res.iters * 1e3,
                peak_gib=peak / 2 ** 30, final_accuracy=res.final_accuracy,
                accuracy=[float(a) for a in res.accuracy], launches=counts)


def same_model(np, got, want, what) -> None:
    np.testing.assert_array_equal(got.weights, want.weights, err_msg=what)
    np.testing.assert_array_equal(got.history, want.history, err_msg=what)


def phase_siloed(ck: Checker, np, fused) -> tuple:
    """FULL_WORKLOAD at full width on the siloed schedule, then
    mnist10_like (the matrix kernel's path); returns (counts per kernel
    from the path that runs it, summaries)."""
    from repro_torch import api
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import ref
    shapes = ShapeLog()
    res, counts, calls, peak = fit_full(
        ck, "0", record=("coded_gradient_batched",), shape_log=shapes)
    assert counts["coded_gradient_batched"] == FULL_ITERS, counts
    assert counts["fused_step"] == 0, counts
    for name in SILOED_PATH:
        assert counts[name] > 0, f"{name} was not launched on the siloed path"
    x, w, co = calls["coded_gradient_batched"][-1][0]
    ck.compare("coded_gradient_batched", cg.coded_gradient_batched(x, w, co),
               ref.coded_gradient_batched(x.cpu(), w.cpu(), co.cpu()),
               f"{res.workload} siloed last step")
    same_model(np, res, fused, "siloed vs fused full-width run")
    summary = run_summary(res, counts, peak)
    summary["gemm_shapes"] = gemm_table(ck, shapes, FULL_ITERS)
    log_gemm_table("siloed", summary["gemm_shapes"])
    no_tiled_gemm(summary["gemm_shapes"])
    set_schedule("0")                      # the siloed run's driver
    proto = api.protocols.driver(api.get_workload(FULL_WORKLOAD),
                                 ck.torch.device("cuda"))
    set_schedule("1")
    assert proto.fused_mode == "0"
    summary["profiled_steps"], summary["profile"] = profile_steps(
        ck.torch, proto.iteration, res.state)
    del calls, x, w, co
    res.state = None
    # host time per step varies from fit to fit: the two schedules in turns
    turns = []
    for mode in ("1", "0", "0", "1"):
        r, _, _, _ = fit_full(ck, mode)
        turns.append(dict(schedule=mode, setup_s=r.timings["setup_s"],
                          ms_per_iter=r.timings["iters_s"] / r.iters * 1e3))
        same_model(np, r, fused, f"turn on schedule {mode}")
    summary["turns"] = turns
    log(f"siloed: {res.workload} setup {summary['setup_s']:.3f} s, "
        f"{summary['ms_per_iter']:.3f} ms/iter, peak "
        f"{summary['peak_gib']:.2f} GiB, accuracy {res.final_accuracy:.4f} "
        f"(equal to the fused run's), launches {counts}")
    log(f"siloed: profiled steps {summary['profiled_steps']}")
    log("siloed: ms/iter in turns " + ", ".join(
        f"{t['schedule']}: {t['ms_per_iter']:.3f}" for t in turns))

    mres, mcounts, mcalls, mpeak = fit_full(
        ck, "0", record=("coded_gradient_matrix",), workload="mnist10_like")
    assert mcounts["coded_gradient_matrix"] == FULL_ITERS, mcounts
    x, w, co = mcalls["coded_gradient_matrix"][-1][0]
    ck.compare("coded_gradient_matrix", cg.coded_gradient_matrix(x, w, co),
               ref.coded_gradient_matrix(x.cpu(), w.cpu(), co.cpu()),
               "mnist10_like siloed last step")
    msummary = run_summary(mres, mcounts, mpeak)
    log(f"siloed: mnist10_like {msummary['ms_per_iter']:.3f} ms/iter, "
        f"accuracy {mres.final_accuracy:.4f}, launches {mcounts}")
    path_counts = dict(counts)
    path_counts["coded_gradient_matrix"] = mcounts["coded_gradient_matrix"]
    return path_counts, {res.workload: summary, "mnist10_like": msummary}


def phase_faulty(ck: Checker, np, fused) -> dict:
    """cifar10_case2 at full width under a fault plan on both schedules:
    a straggler at step 1 and an adversary from step 3, which leaves
    exactly R = 49 of the 50 clients available."""
    from repro_torch import api
    wl = api.get_workload(FULL_WORKLOAD)
    plan = api.FaultPlan.from_schedule(wl.n_clients, FULL_ITERS,
                                       stragglers={1: (0,)},
                                       adversaries={3: (7,)})
    headroom = plan.validate(api.fault_threshold(wl))
    log(f"faulty: {plan.describe()}, headroom per step {headroom.tolist()}")
    out = {}
    for mode in ("1", "0"):
        shapes = ShapeLog()
        res, counts, calls, peak = fit_full(
            ck, mode, record=("fused_step",), faults=plan, shape_log=shapes)
        same_model(np, res, fused, f"faulty (schedule {mode}) vs fault-free")
        if mode == "1":
            offsets = [args[3].cpu() for args, _ in calls["fused_step"]]
            assert len(offsets) == FULL_ITERS
            for step, off in enumerate(offsets):
                hit = (off != 0).nonzero().flatten().tolist()
                assert hit == ([7] if step >= 3 else []), (step, hit)
        else:
            assert counts["coded_gradient_batched"] == FULL_ITERS, counts
        res.state = None
        del calls
        out[f"schedule {mode}"] = run_summary(res, counts, peak)
        gemms = gemm_table(ck, shapes, FULL_ITERS)
        log_gemm_table(f"faulty {mode}", gemms)
        no_tiled_gemm(gemms)
        out[f"schedule {mode}"]["gemm_shapes"] = gemms
        log(f"faulty: schedule {mode}: weights and history equal the "
            f"fault-free run's; {out[f'schedule {mode}']['ms_per_iter']:.3f} "
            f"ms/iter, launches {counts}")
    return out


# (label, kernel, A or x shape, B or W shape, C): the redesigned kernels at
# the main path's shapes, for --compare (cifar10_case2: N=50, mk=902,
# d=3073, K=10, T=7); X^T y's A is the transposed view of (N, m, d) shares,
# the MPC baseline's Z = X W a contiguous (N_g, m/3, d) share tensor
# (row-dot; tiled before), serving's (B, d) @ (d, N) (split-K; tiled
# before); tests/test_torch_gemm_routes.py holds each to its path
COMPARE_SHAPES = [
    ("fused_step", "fused_step", (50, 902, 3073), None, 1),
    ("fused_step C=10", "fused_step", (50, 902, 3073), None, 10),
    ("coded_gradient_batched", "coded_gradient_batched", (50, 902, 3073),
     None, 1),
    ("coded_gradient_matrix C=10", "coded_gradient_matrix", (50, 902, 3073),
     None, 10),
    ("share X (setup)", "modmatmul", (50, 7), (7, 27715387), 0),
    ("LCC encode (setup, x8)", "modmatmul", (50, 17), (17, 2771846), 0),
    ("reconstruct coded X (setup)", "modmatmul", (1, 8), (8, 138592300), 0),
    ("share (per step)", "modmatmul", (50, 7), (7, 153650), 0),
    ("model encode (per step)", "modmatmul_batched", (50, 50, 17),
     (50, 17, 3073), 0),
    ("X^T y (setup)", "modmatmul_batched", (50, 3073, 9019), (50, 9019, 1),
     0),
    ("X^T y C=10 (a 10-class objective)", "modmatmul_batched",
     (50, 3073, 9019), (50, 9019, 10), 0),
    ("MPC baseline Z = X W (per step and group)", "modmatmul_batched",
     (16, 3006, 3073), (16, 3073, 1), 0),
    ("MPC baseline Z = X W C=10", "modmatmul_batched", (16, 3006, 3073),
     (16, 3073, 10), 0),
    ("serving score GEMM, batch 1", "modmatmul", (1, 3073), (3073, 50), 0),
    ("serving score GEMM, batch 32", "modmatmul", (32, 3073), (3073, 50), 0),
    ("serving score GEMM, batch 128", "modmatmul", (128, 3073), (3073, 50),
     0),
    # (label, "poly_eval", (L,), None, degree)
    ("poly_eval L=45100 degree 1", "poly_eval", (45100,), None, 1),
    ("poly_eval L=2^26 degree 1", "poly_eval", (1 << 26,), None, 1),
    ("poly_eval L=2^26 degree 7", "poly_eval", (1 << 26,), None, 7),
]


def gemm_operands(make, label: str, name: str, ashape, bshape) -> tuple:
    """A and B of a COMPARE_SHAPES GEMM from make(*shape): X^T y's A the
    transposed view of (N, m, d) shares, the per-step model encode's A one
    matrix expanded over the batch (stride 0), every other A contiguous."""
    b = make(*bshape)
    if "X^T y" in label:
        a = make(ashape[0], ashape[2], ashape[1]).transpose(1, 2)
    elif label.startswith("model encode"):
        a = make(*ashape[1:])[None].expand(*ashape)
    else:
        a = make(*ashape)
    return a, b


def time_only(src: str) -> dict:
    """Device ms of the redesigned kernels, imported from `src` (this
    checkout's src/, or another checkout's for --compare), at
    COMPARE_SHAPES."""
    import numpy as np
    import torch
    sys.path.insert(0, src)
    from repro_torch.core.field import P
    from repro_torch.kernels import build
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import field_poly as fp
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import modmatmul as mm
    build.build_all()
    ck = Checker(torch, np, P)
    out = {}
    for label, name, ashape, bshape, c in COMPARE_SHAPES:
        if name == "fused_step":
            n, m, d = ashape
            ops_ = fused_operands(ck, n, m, d, c, 1)
            fn = (lambda o: lambda: fs.fused_step(*o["args"], **o["kw"]))(ops_)
        elif name.startswith("coded_gradient"):
            n, m, d = ashape
            x, w, co = ck.field(n, m, d), ck.field(n, d, c), ck.field(2)
            args = (x, w[..., 0], co) if c == 1 else (x, w, co)
            fn = (lambda f, a: lambda: f(*a))(getattr(cg, name), args)
        elif name == "poly_eval":
            z, co = ck.field(*ashape), ck.field(c + 1)
            fn = (lambda z_, c_: lambda: fp.poly_eval(z_, c_))(z, co)
        else:
            a, b = gemm_operands(ck.field, label, name, ashape, bshape)
            fn = (lambda f, a_, b_: lambda: f(a_, b_))(getattr(mm, name), a, b)
        out[label] = device_ms(torch, fn, 5 if "X" in label else 20)
        fn = None
        torch.cuda.empty_cache()
    return out


def compare(parent_src: str) -> dict:
    """The parent checkout's kernels and this one's, each in its own
    process, in turns parent, change, change, parent on one card."""
    runs = []
    for who, src in (("parent", parent_src), ("change", str(REPO / "src")),
                     ("change", str(REPO / "src")), ("parent", parent_src)):
        res = subprocess.run([sys.executable, __file__, "--time-only", src],
                             capture_output=True, text=True, check=True)
        runs.append(dict(who=who, ms=json.loads(res.stdout.splitlines()[-1])))
        log(f"compare: {who} {runs[-1]['ms']}")
    return {"turns": runs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="build, ragged kernel checks and goldens only")
    parser.add_argument("--compare", metavar="PARENT_SRC",
                        help="time the redesigned kernels of PARENT_SRC "
                             "(another checkout's src/) and of this one in "
                             "turns, and stop")
    parser.add_argument("--time-only", metavar="SRC", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    if args.time_only:
        print(json.dumps(time_only(args.time_only)))
        return 0
    if args.compare:
        res = compare(args.compare)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "compare.json").write_text(json.dumps(res, indent=1))
        return 0
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.field import P
    from repro_torch.kernels import build

    report: dict = {"device": torch.cuda.get_device_name(0)}
    secs = build.build_all()
    report["build_s"] = secs
    report["ptxas"] = dict(build.BUILD_LOG)
    log(f"build: CUDA kernels built in {secs:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    set_schedule("1")
    ck = Checker(torch, np, P)
    rows = phase_kernels(ck, args.quick)
    rows.update(phase_kernels_siloed(ck, args.quick))
    rows.update(phase_kernels_protocols(ck, args.quick))
    proc_rows = phase_kernels_proc(ck, args.quick)
    phase_golden(np)
    phase_golden_siloed(np)
    phase_golden_protocols(np)
    # launches: each kernel's count from the full-width path that runs it
    # (coded_gradient and poly_eval are on no path of the protocol)
    counts = {k: 0 for k in TPU_KERNEL}
    path = {k: None for k in TPU_KERNEL}
    by_path = {k: {} for k in TPU_KERNEL}
    if not args.quick:
        fused_counts, summary, fused = phase_full(ck, np)
        report["full"] = summary
        siloed_counts, report["siloed"] = phase_siloed(ck, np, fused)
        report["faulty"] = phase_faulty(ck, np, fused)
        report["protocols"], report["protocol_launches"], float_res = \
            phase_protocols(ck, np, summary)
        report["serve"], report["serve_launches"] = phase_serve(
            ck, np, fused, float_res)
        report["proc"], proc_runs = phase_proc(ck, np, fused)
        fused.state = None                 # frees its device memory
        for name in FUSED_PATH:
            counts[name] = fused_counts[name]
            path[name] = "fused cifar10_case2"
        counts["coded_gradient_batched"] = \
            siloed_counts["coded_gradient_batched"]
        path["coded_gradient_batched"] = "siloed cifar10_case2"
        counts["coded_gradient_matrix"] = \
            siloed_counts["coded_gradient_matrix"]
        path["coded_gradient_matrix"] = "siloed mnist10_like"
        for name in ("modmatmul", "modmatmul_batched"):
            by_path[name] = {
                "fused cifar10_case2": fused_counts[name],
                **{f"{p} cifar10_case2": c[name]
                   for p, c in report["protocol_launches"].items()},
                "serve cifar10_case2": report["serve_launches"].get(name, 0)}
        runs = {"fused": fused_counts, **report["protocol_launches"],
                "serve": report["serve_launches"]}
        for name, (gpath, run) in PATH_ENTRIES.items():
            key = f"gemm:{gpath}"
            counts[name] = runs[run].get(key, 0)
            assert counts[name] > 0, f"{gpath} was not launched on {run}"
            path[name] = f"{run} cifar10_case2"
            by_path[name] = {f"{r} cifar10_case2": c.get(key, 0)
                             for r, c in runs.items()}
        # the proc path: the coordinator's launches plus every worker's
        for run, c in proc_runs.items():
            for name in TPU_KERNEL:
                gpath = PATH_ENTRIES.get(name, (None,))[0]
                by_path[name][run] = c[f"gemm:{gpath}"] if gpath else c[name]
    report["shapes"] = ck.rows

    kernels = []
    for name in TPU_KERNEL:
        r = rows.get(name, {})
        pr = proc_rows.get(name)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=TPU_KERNEL[name], launches=counts[name],
            path=path[name], launches_by_path=by_path[name],
            max_abs_err=ck.max_err[name], equal=ck.max_err[name] == 0,
            checks=ck.checks[name], shape=r.get("shape"), ms=r.get("ms"),
            device_ms=r.get("device_ms"),
            plain_ms=r.get("plain_ms"), bound_ms=r.get("bound_ms"),
            bound_by=r.get("bound_by"), library_ms=None,
            proc_worker=None if pr is None else {
                k: pr[k] for k in ("shape", "ms", "device_ms", "plain_ms",
                                   "bound_ms", "bound_by")}))
    report["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
