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
              each on the thin kernel (a sharded:4 rank's with the rings);
              then a sharded:4 rank's other GEMMs: the monolithic
              reduce-scatter's and all-to-all's, and its serving scores
              (B, 3073) @ (3073, 13) at batch 1, 32 and 128
  3. golden   api.fit on cuda reproduces the smoke goldens (weights, share
              and history sha256) and the pinned mnist10_like /
              linreg_smoke / cifar10_like / smoke_straggler shas of the JAX
              package's runs; smoke_straggler under a fault plan gives the
              JAX package's shas; the MPC baseline (bh08, bgw) and three
              secure_agg aggregation rounds give the JAX package's pinned
              shas (MPC_SHAS, AGG_SHAS), and
              smoke serving of a copml and a float result equals
              reference_scores
  4. full     api.fit("cifar10_case2", "copml", "jit", iters=5) on the card
              at the paper's full width (N=50, m=9019, d=3073, K=10, T=7);
              kernel launch counts are reset just before it and read just
              after, and the last step's fused_step operands are re-checked
              against the plain version
  5. steps    two more steps from phase 4's final state profiled (device
              ms by kernel), and every field GEMM of phase 4's fit counted
              by shape, path and phase (setup, step), re-checked and timed
              by device time; no GEMM of the fit may take the tiled kernel
              (X^T y takes the column-sum kernel)
  6. faulty   the full fit under a fault plan (a straggler, and from step 3
              an adversary: exactly R = 49 available): weights and history
              equal to the fault-free run's, and the fused step's
              adversary offset non-zero at steps 3 and 4, its GEMMs by
              shape and path as in phase 5
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
 10. sharded  api.fit(FULL_WORKLOAD, "copml", "sharded:4", iters=5): the
              client axis split over 4 rank processes on one
              torch.distributed group (gloo through the host with every
              rank on the one card; NCCL with one card a rank), bit-equal
              to phase 4's jit fit (weights, shares, history); every rank
              on cuda, its coded_gradient_batched once a step, no GEMM on
              the tiled kernel, its peak memory and bytes sent by
              collective; setup s and ms/iter; then sharded:1 on NCCL, a
              fault plan with an adversary on sharded:4 under
              REPRO_SHARDED_OVERLAP 0 and 1 (bit-equal to jit under the
              plan), mnist10_like on sharded:4 (coded_gradient_matrix in
              the ranks) and serving the full-width result on sharded:4 at
              batch 1, 32 and 128 (every window equal to reference_scores)
 11. launch   the launch layer, each CLI as a subprocess:
              `python -m repro_torch.launch.copml_dist` at cifar10_case2's
              width (N=50, m=9019, d=3073, K=10, T=7) over 4 ranks, 3
              iterations: bit-exact with jit, then under a seeded fault
              plan (one straggler of headroom, R = 49), then --bench;
              `python -m repro_torch.launch.dryrun --shape all --mesh both
              --execute-ranks 4`: every cell's model at 256 / 512 ranks
              and one real step at 4 ranks, each rank's bytes by
              collective equal to the closed form, smoke and train_4k
              bit-equal to the single-device step, each cell's rank peak
              GiB and roofline terms logged; `python -m
              repro_torch.launch.train` at cifar10_case2, its summary line
              equal to an in-process api.fit's (wall time aside); and
              launch_counter.count_steps over two jit steps (field kernels
              a step, priced; the medians of IDLE_SAMPLES such samples'
              device launches and idle share agreeing with the medians of
              as many profile_steps samples over two steps, taken in turns)
 12. lm       LM serving (models/lm_serving.generate), no field kernel:
              (a) qwen3-1.7b at full width and depth (28 layers, bf16,
              weights from init_params with seed 0), B = 32 prompts of 512
              tokens, 32 new, a 1024-token cache: params GB, prefill s, ms
              a decode step, tokens/s, peak GiB, a profile of two more
              decode steps of generate's own (device ms, idle share,
              launches a step), the prefill and decode-step bounds
              (launch/roofline.lm_*); the same prompts' bf16 prefill and
              decode-step logits against float32 ones from the same
              weights (correlation >= LM_BF16_MIN_CORR); the port's
              flash_attention beside scaled_dot_product_attention
              at the prefill shape (reference only); (b) every other LM
              arch at its published widths, LM_DEPTH layers: in float32
              with TF32 off, prefill then one decode step equal to the
              full forward (MoE at capacity 8), then generate in bf16 (B
              = 8, S0 = 128, 8 new, cache 256 + n_patches), measured as
              in (a); (c) one arch a family (LM_FAMILY_ARCHS) in float32:
              prefill and one decode step's logits and caches on the card
              equal to the CPU's within LM_CPU_TOL
 13. lm_train LM training (models/model_zoo.build(...).train_step, in
              place): (a) qwen3-1.7b at full width and depth (28 layers,
              bf16, adamw, remat), B = 8, S = 1024, loss chunk 512, on
              data/pipeline.lm_batch's stream, weights from init_params
              seed 0: 2 warm-up then 4 timed steps (ms a step, tokens/s,
              peak GiB, parameter and optimizer-state GB), a profile of two
              more (device ms, idle share, launches a step, top kernels),
              the bound (launch/roofline.lm_train_work); the loss finite and
              falling over the 6 steps; (b) every other LM arch at its
              published widths, LM_DEPTH layers, one warm-up and one timed
              bf16 step (B = 4, S = 256); (c) one arch a family in float32,
              TF32 off, on the card against the CPU within LM_CPU_TOL:
              loss_fn's gradients at the published widths (1 layer), one
              whole train_step at SMOKE, and at SMOKE the step with
              microbatching or a chunked loss equal to the plain step;
              (d) train_secure (smollm-360m, 2 layers, N = 4, T = 1, 2
              steps): the thin modmatmul's launches, secure_aggregate on the
              card equal to the CPU's bit for bit (LM_AGG_LEAVES), the thin
              GEMM's device ms and bound; (e) subprocesses: launch.train with
              checkpoints, resumed, equal to a straight run; launch.dryrun
              --arch qwen3-1.7b --shape all --mesh both
 14. wide     the coded gradient past the gradient kernel's d = 58,004
              (kernels/plan.py gradient_route): cifar10_case2's
              configuration at d = 65,536, m = 1,560 (156 coded rows a
              client).  The cluster route (C = 1) against its plain version
              (kernels/ref on the card) at that full shape with rows at
              p - 1 and with every operand p - 1, at odd d = 58,005, at its
              widest d (N = 2, m = 3), at m = 2 and with one client; its
              gradient at every cluster size that fits and as the plan takes
              it, the fused step on it, and the two-read wide route called
              directly, each timed beside its bound; C = 10 on the plan's
              route (wide), timed; each of the wide
              route's four kernels (Z on the row-dot GEMM, ghat on
              poly_eval, X~^T ghat on the column-sum GEMM, the fused step's
              epilogue) at the ten-class shapes against its plain version,
              timed beside its bound; then api.fit binary (the cluster
              route once a step, no two-read gradient) and ten-class (the
              wide route; 5 iterations each; the last steps re-checked, no
              tiled GEMM), two binary and two ten-class steps profiled, the
              binary
              result served at batch 32 (split-K at K = 65,536, equal to
              reference_scores), and sharded:4 bit-equal to jit over 2
              steps (the cluster route in every rank).  Phase 10 also times
              a sharded rank's score GEMM, K split over CTAs on rowdot, at
              batch 1, 32 and 128 against its times before the split

 15. threefry the threefry kernel (csrc/threefry.cu, one launch a draw;
              replaces no TPU kernel: the JAX package draws with
              jax.random) against core/random.py's plain int64 version,
              bit for bit, one launch a draw by ops.threefry_counts: the
              six draws of a cifar10_case2 step, set-up's (7, 9019, 3073)
              (against the plain version on the card), odd sizes, a span
              whose uint32 multiplier is nonzero, negative minval, rows
              of 3 and 70 keys, bits32 at odd sizes; timed at 194M and
              1.08M words (CUDA events, device time, the plain version on
              the card, the bound), and a step's six draws on the host
              clock, kernel against plain; the built kernel's opcodes by
              cuobjdump (the floor's premise, kernels/threefry.py
              ALU_OPS_PAIR).  Its kernels-line entry counts the launches
              of phase 4's fit (every draw of set-up and of each step),
              and by path the protocol, serving, proc, sharded, wide and
              launch_counter runs' (ops.threefry_counts: the caller's plus
              every worker's or rank's).  --threefry-only runs it alone
              into chiprun_out/chip_smoke_threefry.json, its entry
              counting a step's six draws

Output: one {"kernels": [...]} JSON line (the seven TPU kernels' ports,
then the row-dot and split-K paths of modmatmul, the wide route's four
kernels and the cluster gradient kernel as entries of their own, and last
the threefry kernel (no TPU counterpart; not in --quick),
each with its launches on the full-width path that runs it and its times
at that path's shape (asserted), its launches by path -- the proc:4 runs' summed over the coordinator and the workers --
and its time at a proc worker's shape where it runs there), the card's
name and power limit (nvidia-smi), then {"ok": true, "device": {...}} as
the last line.
Details (per-shape timings, poly_eval's device time at L = 45,100 and 2^26,
the ptxas report, a profile of two steps) go to chip_smoke.json in OUT_DIR.

  python3 chip_smoke.py            # every phase (needs one CUDA card)
  python3 chip_smoke.py --quick    # build, ragged kernel checks, goldens
      # (phases 1-3)
  python3 chip_smoke.py --launch-only   # build, then phase 11 alone
  python3 chip_smoke.py --lm-only       # build, then phase 12 alone
  python3 chip_smoke.py --lm-train-only # build, then phase 13 alone
  python3 chip_smoke.py --wide-only     # build, then phase 14 alone
  python3 chip_smoke.py --threefry-only # build, then phase 15 alone
  python3 chip_smoke.py --compare OTHER/src   # the redesigned kernels of
      # another checkout (e.g. the parent commit's) and of this one, timed
      # in turns other, this, this, other; writes chiprun_out/compare.json
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import os
import statistics
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
# package's (shares sha, history sha)
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

# the kernels the full-width path launches (every one at least once)
FUSED_PATH = ("modmatmul", "modmatmul_batched", "fused_step")
# the other protocols' and serving's paths (float GD runs no field kernel)
PROTOCOL_PATHS = {"mpc_baseline": ("modmatmul", "modmatmul_batched"),
                  "secure_agg": ("modmatmul",), "float": (),
                  "poly_float": ()}
SERVE_PATH = ("modmatmul",)
SERVE_BATCHES = (1, 32, 128)
SERVE_QUERIES = 1024
PROC_N = 4
PROC_ENGINE = f"proc:{PROC_N}"
SHARDED_N = 4
SHARDED_ENGINE = f"sharded:{SHARDED_N}"
# rank 3's frames arrive 0.35 s late everywhere; the others decode after
# 0.05 s without its blocks
STRAGGLER_NET = dict(links=((3, None, 0.35),), decode_timeout_s=0.05)
# phase 11: copml_dist at cifar10_case2's width over 4 ranks; the fault
# plan (p = 0.02, seed 1) leaves 50, 49, 50 of the 50 clients available
# (R = 49): one straggler at step 1, and a different decode subset there
LAUNCH_DIST = ("--devices", "4", "--clients", "50", "--m", "9019", "--d",
               "3073", "--iters", "3")
LAUNCH_FAULTS = ("--straggle-p", "0.02", "--fault-seed", "1")
LAUNCH_CHURN = "available 49..50"
DRYRUN_SHAPES = ("smoke", "train_4k", "prefill_32k", "decode_32k")
DRYRUN_RANKS = 4
# launch_counter against profile_steps: samples of two steps each, taken in
# turns.  A two-step sample's idle share is ~40 ms of host wall time, so
# one pause of the shared host moves it by more than the band; the medians
# of the samples are compared.
IDLE_SAMPLES = 5
# phase 12: LM serving.  (a) the main path at full width and depth; (b)
# every other LM arch at its published widths, LM_DEPTH layers (2 unless
# named: zamba2 one shared-attention group, arctic 26.8 GB of experts a
# layer in bf16, whisper its full 4 + 4); (c) one arch a family, card vs CPU
LM_MAIN = "qwen3-1.7b"
LM_MAIN_RUN = dict(batch=32, prompt=512, new=32, cache=1024)
LM_OTHER_RUN = dict(batch=8, prompt=128, new=8, cache=256)
LM_DEPTH = {"qwen3-1.7b": 2, "zamba2-2.7b": 6, "arctic-480b": 1,
            "whisper-tiny": 4}
LM_FAMILY_ARCHS = ("qwen3-1.7b", "internvl2-2b", "qwen3-moe-30b-a3b",
                   "falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")
LM_CHECK_B, LM_CHECK_S = 2, 32
# float32, TF32 off: decode after prefill against the full forward, of
# max |logit|; the card against the CPU, relative to max |CPU value|
LM_PROPERTY_TOL = 1e-3
LM_CPU_TOL = 1e-4
# (a) the main path's bf16 logits against float32 ones, same weights and
# prompts: correlation, as the CPU tests hold bf16 to JAX's
LM_BF16_MIN_CORR = 0.999
# the kernels a decode step's profile lists, by device time
LM_TOP_KERNELS = 8
# phase 13: LM training.  (a) the main path at full width and depth, 2
# warm-up steps then 4 timed; (b) every other arch at its published widths
# and LM_DEPTH layers, one warm-up and one timed step; (d) train_secure;
# (e) launch.train's resume (smoke config)
LM_TRAIN_MAIN = dict(batch=8, seq=1024, loss_chunk=512)
LM_TRAIN_WARM, LM_TRAIN_TIMED = 2, 4
LM_TRAIN_OTHER = dict(batch=4, seq=256, loss_chunk=128)
# (c) card against CPU: gradients at the published widths, one layer
# (zamba2 one shared-attention group of 6); the whole step at SMOKE
LM_TRAIN_CHECK_DEPTH = {"zamba2-2.7b": 6}
LM_SECURE = dict(arch="smollm-360m", layers=2, n=4, t=1, steps=2, batch=8,
                 seq=128)
LM_RESUME = dict(batch=8, seq=128, ckpt_every=3)

# phase 14: the coded gradient's wide route.  cifar10_case2's
# configuration (N = 50, K = 10, T = 7, r = 1, eta by _field_safe_cfg's
# rule) at d = 65,536, past the gradient kernel's d = 58,004, and m = 1,560
# (156 coded rows a client): binary, and ten-class one-vs-rest
WIDE_D, WIDE_M = 65536, 1560
WIDE_NAME = "cifar10_case2_wide"
WIDE10_NAME = "cifar10_case2_wide_ovr10"
WIDE_SHARDED_ITERS = 2
WIDE_SERVE_BATCH = 32
WIDE_SERVE_QUERIES = 256

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
    "fused_step.wide_z": "src/repro/kernels/fused_step.py:138",
    "fused_step.wide_ghat": "src/repro/kernels/fused_step.py:138",
    "fused_step.wide_xtg": "src/repro/kernels/fused_step.py:138",
    "fused_step.wide_epilogue": "src/repro/kernels/fused_step.py:138",
    "fused_step.cluster": "src/repro/kernels/fused_step.py:138",
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
    "fused_step.wide_z": "src/repro_torch/kernels/csrc/modmatmul.cu",
    "fused_step.wide_ghat": "src/repro_torch/kernels/csrc/field_poly.cu",
    "fused_step.wide_xtg": "src/repro_torch/kernels/csrc/modmatmul.cu",
    "fused_step.wide_epilogue": "src/repro_torch/kernels/csrc/fused_step.cu",
    "fused_step.cluster":
        "src/repro_torch/kernels/csrc/coded_gradient_cluster.cuh",
}
# the modmatmul paths with entries of their own in the kernels line: the
# GEMM path, and the full-width run whose launches they report
PATH_ENTRIES = {"modmatmul_batched.rowdot": ("rowdot", "mpc_baseline"),
                "modmatmul.splitk": ("splitk", "serve")}
# the kernels past d = 58,004 (phase 14), entries of their own: the key of
# ops.wide_counts each one counts (a wide gradient launches Z, ghat and
# X~^T ghat once each; a cluster gradient the cluster kernel once), and the
# phase-14 run whose launches the kernels line reports: the cluster kernel
# carries the binary fits (C = 1), the wide route the ten-class ones
WIDE_ENTRIES = {"fused_step.wide_z": "gradient",
                "fused_step.wide_ghat": "gradient",
                "fused_step.wide_xtg": "gradient",
                "fused_step.wide_epilogue": "epilogue",
                "fused_step.cluster": "cluster"}
WIDE_RUN = {name: f"fused {WIDE10_NAME}" for name in WIDE_ENTRIES}
WIDE_RUN["fused_step.cluster"] = f"fused {WIDE_NAME}"
# a sharded:4 rank's serving scores (B, 3073) @ (3073, 13) on rowdot before
# its K was split: device ms at each of SERVE_BATCHES (PERF.md section 6,
# NVIDIA H100 80GB HBM3, 700 W)
RANK_SCORES_BEFORE_MS = {1: 0.0323, 32: 0.0328, 128: 0.0331}


def count_key(name: str) -> str:
    """The run_counts key of a kernels-line entry."""
    if name in PATH_ENTRIES:
        return f"gemm:{PATH_ENTRIES[name][0]}"
    if name in WIDE_ENTRIES:
        return f"wide:{WIDE_ENTRIES[name]}"
    return name


def log(*args):
    print(*args, flush=True)


def run_counts() -> dict:
    """The launch counts since the last ops.reset_launches(): each kernel's,
    the field GEMM's by path under "gemm:<path>", the cluster route's
    gradients, the wide route's gradients and its epilogues under
    "wide:cluster", "wide:gradient" and "wide:epilogue", and the threefry
    kernel's launches (every entry) under "threefry"."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    counts.update({f"gemm:{p}": c for p, c in ops.gemm_path_counts().items()})
    counts.update({f"wide:{s}": c for s, c in ops.wide_counts().items()})
    counts["threefry"] = sum(ops.threefry_counts().values())
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
        self.max_err = {k: 0 for k in (*TPU_KERNEL, "threefry")}
        self.checks = {k: 0 for k in (*TPU_KERNEL, "threefry")}
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

    def compare_on_card(self, name, got, want, what):
        """compare() without the copy to the host, 2^26 columns at a time:
        for outputs of several GB."""
        torch, cols = self.torch, 1 << 26
        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        err = 0
        for c0 in range(0, got.shape[-1], cols):
            gap = (got[..., c0:c0 + cols].to(torch.int64)
                   - want[..., c0:c0 + cols].to(torch.int64)).abs()
            err = max(err, int(gap.max()) if gap.numel() else 0)
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
    """launch/roofline.bound: (least ms, what bounds it) on an H100."""
    from repro_torch.launch.roofline import bound as roofline_bound
    return roofline_bound(bytes_moved, ops)


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
                             bound_ms=bb, bound_by=by,
                             workload="cifar10_case2")
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
                   bound_by=by, path="colsum", workload="cifar10_case2")
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
            rows["fused_step"] = dict(rec, workload=label)
        del ops_
    torch.cuda.empty_cache()
    log(f"kernels: main-path checks passed {dict(ck.checks)}")
    return rows


def profile_steps(torch, step, state) -> tuple:
    """Two more steps `state = step(key, state)` (e.g. a protocol's
    iteration) from `state` under torch.profiler
    (launch/launch_counter.profile_steps): wall and device ms per step, the
    device's idle share and its kernels per step, and the table of device
    time by kernel."""
    from repro_torch.launch import launch_counter
    summary, table, _ = launch_counter.profile_steps(step, state)
    summary = {k: summary[k] for k in (
        "wall_ms_per_step", "device_ms_per_step", "idle_share",
        "device_kernels_per_step")}
    return summary, table


def fused_operands(ck: Checker, n, m, d, c, degree) -> dict:
    from repro_torch.core import field
    args = (ck.field(n, m, d), ck.field(n, d, c), ck.field(degree + 1),
            ck.field(n), ck.field(n), ck.field(n), ck.field(n, d, c),
            ck.field(n, d, c), ck.field(n, d, c), ck.field(n, d, c),
            ck.field(n, d, c))
    return {"args": args,
            "kw": dict(q_eta=int(ck.rng.integers(1, ck.P)),
                       inv2k1=field.host_inv(1 << 18), k1=18)}


GEMM_TIMES: dict = {}          # (op, shapes, strides) -> (device ms, bound)


def gemm_table(ck: Checker, shape_log, iters: int) -> list:
    """Every GEMM shape of a fit with its launches (setup; per step scaled
    to a 50-iteration fit), path, device time, bound and the time lost
    against the bound in a 50-iteration fit; each shape is checked against
    the plain version on a column slice."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref
    from repro_torch.launch import launch_counter, roofline
    rows = []
    for key, count in sorted(shape_log.calls.items(), key=str):
        phase, name, ash, ast, bsh, bst = key
        k_ = ash[-1]
        path = launch_counter.path_of_key(ash, ast, bsh, bst)
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
            ops_, bytes_ = roofline.gemm_work(ash, ast, bsh, bst)
            bb, by = bound(bytes_, ops_)
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
    plan = api.FaultPlan.from_schedule(13, 6, **FAULT_SCHEDULE)
    r = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                faults=plan, device="cuda")
    got = (sha(r.state.w_shares.cpu().numpy(), np.int32),
           sha(r.history, np.float32))
    assert got == FAULTY_SHAS, got
    log("golden: smoke goldens, pinned shas and the fault plan's shas "
        "reproduced on cuda")


def phase_full(ck: Checker, np) -> tuple:
    """cifar10_case2 at full width; returns (launch counts, summary)."""
    from repro_torch.launch.launch_counter import LaunchLog
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
    with LaunchLog() as shapes:
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
    assert not any(counts[f"wide:{s}"] for s in WIDE_ENTRIES.values()), \
        f"the wide route ran at d = {wl.d}: {counts}"
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

def phase_kernels_gradient(ck: Checker, quick: bool) -> dict:
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
    log(f"kernels: coded-gradient ragged checks passed {dict(ck.checks)}")
    if quick:
        return {}

    # -- main-path shapes: one cifar10_case2 step (N=50, mk=902, d=3073),
    #    its C=10 twin, mnist10_like's matrix step, one client, and the z of
    #    one cifar10_case2 step for poly_eval.  The kernels line takes the
    #    row of the workload whose run it counts (the C=10 twin is no run's)
    rows = {}
    for name, label, wl_, (n, m, d, c) in [
            ("coded_gradient_batched", "cifar10_case2", "cifar10_case2",
             (50, 902, 3073, 1)),
            ("coded_gradient_matrix", "cifar10_case2 C=10", None,
             (50, 902, 3073, 10)),
            ("coded_gradient_matrix", "mnist10_like", "mnist10_like",
             (13, 98, 24, 10)),
            ("coded_gradient", "one cifar10_case2 client", "cifar10_case2",
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
        if wl_ is not None:
            rows.setdefault(name, dict(rec, workload=wl_))
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
        rows.setdefault("poly_eval", dict(rec, workload="cifar10_case2"))
        del z, co
    log(f"kernels: coded-gradient main-path checks passed {dict(ck.checks)}")
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
            rows.setdefault("modmatmul_batched.rowdot",
                            dict(rec, workload="cifar10_case2"))
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
            rows.setdefault("modmatmul.splitk",
                            dict(rec, workload="cifar10_case2"))
    log(f"kernels: row-dot and split-K GEMM checks at the MPC baseline's "
        f"and serving's shapes passed {dict(ck.checks)}")
    return rows


def strided_gemm_row(ck: Checker, name: str, ash, ast, bsh, bst,
                     what: str, count: int) -> dict:
    """One field GEMM with the shapes and strides a caller passes, against
    its plain version (CPU copies, exact) and timed by device time with
    its bound; appended to ck.rows and returned."""
    torch = ck.torch
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ref
    a, abase = strided_field(ck, ash, ast)
    b, bbase = strided_field(ck, bsh, bst)
    path = mm.path_of(*((a[None], b[None]) if name == "modmatmul"
                        else (a, b)))
    fn = (lambda f, a_, b_: lambda: f(a_, b_))(getattr(mm, name), a, b)
    out = fn()
    ck.compare(name, out[..., :2048],
               getattr(ref, name)(a.cpu(), b[..., :2048].cpu()),
               f"{what}: {path} {ash}@{bsh} strides {ast} {bst}")
    bsz, (m_, k_), n_ = ((1, ash, bsh[1]) if name == "modmatmul"
                         else (ash[0], ash[1:], bsh[2]))
    bb, by = bound(4.0 * (min(a.numel(), abase.numel())
                          + min(b.numel(), bbase.numel()) + out.numel()),
                   2.0 * bsz * m_ * k_ * n_)
    rec = dict(shape=f"{ash}@{bsh} strides {ast} {bst}", path=path,
               launches_per_step=count, ms=ck.time_ms(fn, 30),
               device_ms=device_ms(torch, fn, 30),
               plain_ms=ck.time_ms(lambda: getattr(ref, name)(a, b), 2),
               bound_ms=bb, bound_by=by)
    ck.rows.append(dict(kernel=name, what=what, **rec))
    log(f"  {what}: {name:17s} {rec['shape']:60s} x{count}/step "
        f"{path} {rec['device_ms']} ms (bound {bb:.4f})")
    return rec


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
        rec = strided_gemm_row(ck, name, ash, ast, bsh, bst,
                               "proc:4 worker step", count)
        assert rec["path"] == "thin", (name, ash, bsh, rec["path"])
    # a sharded:4 rank's GEMMs: with REPRO_SHARDED_OVERLAP=1 (the rings)
    # those of a proc:4 worker; the monolithic forms' two; its scores when
    # serving at each of SERVE_BATCHES
    n_pad, dw = 52, 3073
    for what, name, ash, ast, bsh, bst, count in [
            ("sharded:4 rank, monolithic reduce-scatter", "modmatmul",
             (1, 13), (13, 1), (13, 50 * dw), (50 * dw, 1), 1),
            ("sharded:4 rank, monolithic all-to-all", "modmatmul",
             (n_pad, 7), (7, 1), (7, 13 * dw), (n_pad * dw, 1), 1)] + [
            (f"sharded:4 rank, serving batch {b}", "modmatmul",
             (b, dw), (dw, 1), (dw, 13), (13, 1), 1)
            for b in SERVE_BATCHES]:
        strided_gemm_row(ck, name, ash, ast, bsh, bst, what, count)
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
    from repro_torch.launch.launch_counter import LaunchLog
    torch = ck.torch
    from repro_torch import api
    from repro_torch.core import cost_model
    wl = api.get_workload(FULL_WORKLOAD)
    out, counts_by, float_res = {}, {}, None
    for protocol, path in PROTOCOL_PATHS.items():
        shapes = None
        if protocol in ("mpc_baseline", "secure_agg"):
            shapes = LaunchLog(protocol if protocol == "mpc_baseline"
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
    from repro_torch.launch.launch_counter import LaunchLog
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
            shapes = LaunchLog(None)
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
        for step, c in rec["wide"].items():
            total[f"wide:{step}"] += c
        total["threefry"] += sum(rec["threefry"].values())
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


def rank_reset(rank) -> None:
    """(On a mesh rank) zero its launch counts."""
    from repro_torch.kernels import ops
    ops.reset_launches()


def rank_counts(rank) -> dict:
    """(On a mesh rank) its launch counts, run_counts' keys."""
    return run_counts()


def sharded_counts(coord: dict, ranks: list) -> dict:
    """Launches of a sharded run, run_counts' keys: the caller's (its setup
    and the final opening) plus every rank's."""
    total = dict(coord)
    for rec in ranks:
        for name, c in rec["launches"].items():
            total[name] += c
        for path, c in rec["gemm_paths"].items():
            total[f"gemm:{path}"] += c
        for step, c in rec["wide"].items():
            total[f"wide:{step}"] += c
        total["threefry"] += sum(rec["threefry"].values())
    return total


def sharded_ranks_ok(res, iters: int, kernel: str, mesh) -> None:
    """Every rank ran on its card with the mesh's backend, launched
    `kernel` (its coded gradient; "cluster" or "wide" for the routes past
    d = 58,004) once a step and fused_step never, and took no GEMM down the
    tiled path."""
    ranks = res.timings["ranks"]
    assert [r["device"] for r in ranks] == [str(d) for d in mesh.devices], \
        ranks
    for rec in ranks:
        assert rec["device"].startswith("cuda"), rec
        assert rec["backend"] == mesh.backend, rec
        got = rec["wide"]["gradient"] if kernel == "wide" else \
            rec["wide"]["cluster"] if kernel == "cluster" else \
            rec["launches"][kernel]
        assert got == iters, (kernel, rec["launches"], rec["wide"])
        assert rec["launches"]["fused_step"] == 0, rec["launches"]
        assert rec["gemm_paths"]["thin"] > 0, rec["gemm_paths"]
        assert rec["gemm_paths"]["tiled"] == 0, rec["gemm_paths"]


def fit_sharded(ck: Checker, workload, engine, iters: int, **kw) -> tuple:
    """api.fit(workload, "copml", engine) on the card with the launch
    counts reset just before and read just after (the caller's plus every
    rank's); returns (result, counts, caller peak bytes above what was
    held when it started)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launches()
    res = api.fit(workload, "copml", engine, key=0, iters=iters,
                  device="cuda", **kw)
    counts = sharded_counts(run_counts(), res.timings["ranks"])
    return res, counts, torch.cuda.max_memory_allocated() - held


def same_state(np, got, want, what) -> None:
    """Weights, history and model shares equal."""
    same_model(np, got, want, what)
    np.testing.assert_array_equal(got.state.w_shares.cpu().numpy(),
                                  want.state.w_shares.cpu().numpy(),
                                  err_msg=f"{what}: shares")


def phase_sharded(ck: Checker, np, fused) -> tuple:
    """The sharded engine on the card: FULL_WORKLOAD over SHARDED_N rank
    processes, bit-equal to phase 4's jit fit; sharded:1 on NCCL; a fault
    plan with an adversary on both REPRO_SHARDED_OVERLAP settings against
    jit under the same plan; mnist10_like (the matrix kernel in the
    ranks); serving the full-width result on SHARDED_N ranks at every
    SERVE_BATCHES.  Returns (summary, {run: counts})."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.core import meshutil
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import plan as kplan
    from repro_torch.kernels import ref
    from repro_torch.serve import coded
    wl = api.get_workload(FULL_WORKLOAD)
    wl.client_data()                       # dataset build is set-up
    t0 = time.perf_counter()
    mesh = meshutil.client_mesh(SHARDED_N, "cuda")
    spawn_s = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    want_backend = "nccl" if cards >= SHARDED_N else "gloo"
    want_devices = [torch.device("cuda", r if want_backend == "nccl" else 0)
                    for r in range(SHARDED_N)]
    assert (mesh.backend, mesh.devices) == (want_backend, want_devices), \
        (mesh.backend, mesh.devices)
    log(f"sharded: {SHARDED_ENGINE} on {cards} card(s): backend "
        f"{mesh.backend}, ranks on {[str(d) for d in mesh.devices]}, "
        f"started in {spawn_s:.2f} s")

    # (a) the full-width fit, after a one-step smoke fit that warms the
    # ranks (their first launches load the kernels' libraries and modules)
    api.fit("smoke", "copml", mesh, iters=1, history=False, device="cuda")
    res, counts, peak = fit_sharded(ck, wl, SHARDED_ENGINE, FULL_ITERS)
    assert res.engine == SHARDED_ENGINE
    same_state(np, res, fused, f"{SHARDED_ENGINE} vs jit full-width run")
    sharded_ranks_ok(res, FULL_ITERS, "coded_gradient_batched", mesh)
    ranks = res.timings["ranks"]
    summary = dict(run_summary(res, counts, peak), backend=mesh.backend,
                   spawn_s=spawn_s, ranks=ranks)
    log(f"sharded: {wl.name} {SHARDED_ENGINE} setup "
        f"{summary['setup_s']:.3f} s, {summary['ms_per_iter']:.3f} ms/iter, "
        f"caller peak {summary['peak_gib']:.2f} GiB, accuracy "
        f"{res.final_accuracy:.4f} (equal to jit's); launches {counts}")
    log("sharded: ranks " + "; ".join(
        f"rank {r['rank']} {r['device']} {r['backend']} loop "
        f"{r['iters_s']:.3f} s, peak {r['peak_bytes'] / 2 ** 30:.3f} GiB, "
        f"MB sent a step "
        f"{ {k: round(v / FULL_ITERS / 1e6, 4) for k, v in r['sent_bytes'].items()} }"
        f", launches { {k: v for k, v in r['launches'].items() if v} }, "
        f"paths { {k: v for k, v in r['gemm_paths'].items() if v} }"
        for r in ranks))
    res.state = None
    runs = {f"{SHARDED_ENGINE} {wl.name}": counts}

    # (b) one rank on NCCL
    one = meshutil.client_mesh(1, "cuda")
    assert (one.backend, one.devices) == ("nccl", [torch.device("cuda", 0)])
    api.fit("smoke", "copml", one, iters=1, history=False, device="cuda")
    r1, _, _ = fit_sharded(ck, wl, "sharded:1", FULL_ITERS)
    same_state(np, r1, fused, "sharded:1 (nccl) vs jit full-width run")
    sharded_ranks_ok(r1, FULL_ITERS, "coded_gradient_batched", one)
    summary["sharded:1"] = dict(run_summary(r1, {}, 0), backend=one.backend,
                                ranks=r1.timings["ranks"])
    log(f"sharded: sharded:1 on nccl bit-equal to jit; "
        f"{summary['sharded:1']['ms_per_iter']:.3f} ms/iter")
    r1.state = None
    one.close()

    # (c) a fault plan with an adversary, both overlap settings
    plan = api.FaultPlan.from_schedule(wl.n_clients, FULL_ITERS,
                                       stragglers={1: (0,)},
                                       adversaries={3: (7,)})
    jref, _, _, _ = fit_full(ck, faults=plan)
    summary["faulty"] = {}
    for overlap in ("0", "1"):
        os.environ["REPRO_SHARDED_OVERLAP"] = overlap
        try:
            fres, fcounts, _ = fit_sharded(ck, wl, SHARDED_ENGINE,
                                           FULL_ITERS, faults=plan)
        finally:
            del os.environ["REPRO_SHARDED_OVERLAP"]
        same_state(np, fres, jref, f"faulty {SHARDED_ENGINE} overlap "
                   f"{overlap} vs jit under the plan")
        np.testing.assert_array_equal(fres.availability, plan.available)
        sharded_ranks_ok(fres, FULL_ITERS, "coded_gradient_batched", mesh)
        kinds = {"0": "all_to_all", "1": "ring_all_to_all"}[overlap]
        assert all(kinds in r["sent_bytes"] for r in fres.timings["ranks"])
        summary["faulty"][f"overlap {overlap}"] = run_summary(fres, fcounts,
                                                              0)
        log(f"sharded: fault plan (straggler at step 1, adversary from "
            f"step 3), REPRO_SHARDED_OVERLAP={overlap}: bit-equal to jit "
            f"under the plan, "
            f"{summary['faulty'][f'overlap {overlap}']['ms_per_iter']:.3f} "
            f"ms/iter")
        fres.state = None
    jref.state = None

    # (d) the matrix kernel in the ranks
    mref = api.fit("mnist10_like", "copml", "jit", key=0, iters=3,
                   device="cuda")
    mres, mcounts, _ = fit_sharded(ck, "mnist10_like", SHARDED_ENGINE, 3)
    same_state(np, mres, mref, f"mnist10_like {SHARDED_ENGINE} vs jit")
    sharded_ranks_ok(mres, 3, "coded_gradient_matrix", mesh)
    runs[f"{SHARDED_ENGINE} mnist10_like"] = mcounts
    log(f"sharded: mnist10_like {SHARDED_ENGINE} bit-equal to jit, "
        f"launches {mcounts}")

    # (e) serving the full-width result
    q = np.asarray(wl.eval_set()[0][:SERVE_QUERIES], np.float32)
    want = coded.reference_scores(fused.weights, q, wl.cfg,
                                  device="cpu").numpy()
    summary["serve"] = {}
    for b in SERVE_BATCHES:
        srv = api.serve(wl, fused, SHARDED_ENGINE, batch_size=b,
                        device="cuda")
        assert srv.model.from_shares and srv.mesh is mesh
        got = np.concatenate([srv.score_field(q[i:i + b])
                              for i in range(0, len(q), b)])
        np.testing.assert_array_equal(got, want, err_msg=f"sharded {b}")
        mesh.run(rank_reset)
        preds, stats = srv.serve(q)
        rc = mesh.run(rank_counts)
        # a rank's scores: (b, d) @ (d, n_loc C'), one launch a window
        n_loc = -(-wl.n_clients // SHARDED_N)
        gpath = mm.path_of(torch.empty((1, b, wl.d), dtype=torch.int32),
                           torch.empty((1, wl.d, n_loc), dtype=torch.int32))
        for c in rc:
            assert c[f"gemm:{gpath}"] >= stats["batches"], (gpath, c)
            assert c["gemm:tiled"] == 0, c
        summary["serve"][f"batch {b}"] = dict(
            queries_per_s=stats["queries_per_s"], serve_s=stats["serve_s"],
            encode_s=stats["encode_s"], batches=stats["batches"],
            score_path=gpath, rank_launches=rc)
        log(f"sharded: serve {wl.name} {SHARDED_ENGINE} batch {b}: every "
            f"window equal to reference_scores; ranks score on {gpath}; "
            f"{stats['queries_per_s']:.0f} queries/s over "
            f"{stats['queries']} queries; rank 0 launches "
            f"{ {k: v for k, v in rc[0].items() if v} }")
        del srv
        # a rank's score GEMM alone, K split over CTAs on rowdot
        a, y = ck.field(b, wl.d), ck.field(wl.d, n_loc)
        shape = kplan.rowdot_shape(n_loc, wl.d)
        launch = kplan.rowdot_launch(b, n_loc, wl.d, 1, mm._rowdot_slots(
            shape["cmax"], shape["smem"]))
        ck.compare("modmatmul", mm.modmatmul(a, y), ref.modmatmul(a, y),
                   f"a sharded rank's scores batch {b}, {launch['splits']} "
                   f"splits of K")
        dev = device_ms(torch, lambda: mm.modmatmul(a, y), 50)
        summary["serve"][f"batch {b}"].update(
            rank_scores_device_ms=dev, rank_scores_launch=launch)
        log(f"sharded: a rank's scores ({b}, {wl.d}) @ ({wl.d}, {n_loc}) on "
            f"{gpath}, {launch['splits']} splits of {launch['ks']} rows of "
            f"K, {launch['cpb']} strips: {dev} device ms (before the split "
            f"{RANK_SCORES_BEFORE_MS[b]})")
        del a, y
    return summary, runs


def run_module(module: str, args, what: str) -> str:
    """`python -m module args` from the repo's src (check=True: a failure
    fails the phase); logs and returns its standard output."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    for line in out.splitlines():
        log(f"launch: {what}: {line}")
    return out


def without_time(summary: str) -> str:
    """A TrainResult summary line without its wall time."""
    import re
    return re.sub(r"iters in [0-9.]+s", "iters in <s>", summary)


def phase_launch(ck: Checker, np) -> tuple:
    """The launch layer: copml_dist's parity (plain and under a seeded
    fault plan) and its bench, the dry run of every copml-logreg cell at
    pod and multipod (each executed at DRYRUN_RANKS ranks), launch.train
    against an in-process api.fit, and launch_counter over two jit steps
    against profile_steps.  Returns (summary, launch counts of the
    in-process steps)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.core import meshutil
    from repro_torch.kernels import ops
    from repro_torch.launch import launch_counter, roofline
    t_phase = time.perf_counter()
    meshutil.close_meshes()                # phase 10's ranks
    torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"launch: card {sms} SMs, max / current SM clock {smi}; "
        f"roofline.py prices {roofline.SMS} SMs at "
        f"{roofline.BOOST_CLOCK_HZ / 1e6:.0f} MHz: "
        f"{roofline.FIELD_OPS_PER_S:.4g} field ops/s")
    summary = dict(card_sms=sms, card_clocks=smi)

    # (a) copml_dist at full width: parity, under the fault plan, bench
    dist = "repro_torch.launch.copml_dist"
    out = run_module(dist, LAUNCH_DIST, "copml_dist")
    assert "bit-exact: sharded == jit" in out, out
    out = run_module(dist, LAUNCH_DIST + LAUNCH_FAULTS, "copml_dist faults")
    assert "bit-exact: sharded == jit" in out and LAUNCH_CHURN in out, out
    out = run_module(dist, LAUNCH_DIST + ("--bench",), "copml_dist bench")
    rows = [r.split(",") for r in out.splitlines() if r.startswith(
        "copml_dist/")]
    assert len(rows) == 2, out
    summary["bench"] = {r[0]: dict(best_us=float(r[1]), ratio=r[2])
                        for r in rows}

    # (b) the dry run: every cell modelled and executed
    out_dir = OUT_DIR / "dryrun"
    out = run_module("repro_torch.launch.dryrun", (
        "--arch", "copml-logreg", "--shape", "all", "--mesh", "both",
        "--execute-ranks", str(DRYRUN_RANKS), "--out", str(out_dir)),
        "dryrun")
    assert out.splitlines()[-1] == "dry-run: all requested cells compiled"
    summary["dryrun"] = {}
    for mesh_name in ("pod", "multipod"):
        skip = json.loads((out_dir / f"copml-logreg_long_500k_{mesh_name}"
                           ".json").read_text())
        assert skip["status"].startswith("skipped"), skip
        for shape in DRYRUN_SHAPES:
            rec = json.loads((out_dir / f"copml-logreg_{shape}_{mesh_name}"
                              ".json").read_text())
            ex = rec["executed"]
            assert rec["status"] == "model" and ex["ranks"] == DRYRUN_RANKS
            assert ex["device"].startswith("cuda"), ex["device"]
            for sent in ex["sent_bytes"]:
                assert {k: v for k, v in sent.items() if v} == \
                    ex["sent_bytes_closed_form"], (shape, mesh_name, sent)
            if shape in ("smoke", "train_4k"):
                assert ex["bit_equal_single_device"], (shape, mesh_name)
            terms = ("compute_s", "memory_s", "collective_s", "dominant")
            summary["dryrun"][f"{shape} {mesh_name}"] = dict(
                n=rec["n_clients"], k=rec["K"], t=rec["T"],
                model={k: rec[k] for k in terms},
                model_args_gib=rec["bytes_per_device"]["argument"] / 2 ** 30,
                model_sent=rec["sent_bytes_per_rank"],
                executed={k: ex["roofline"][k] for k in terms},
                rank_peak_gib=max(ex["peak_bytes"]) / 2 ** 30,
                rank_state_gib=ex["state_bytes_per_rank"][0] / 2 ** 30,
                step_s=ex["step_s"], make_rows_s=ex["make_rows_s"],
                sent=ex["sent_bytes_closed_form"],
                wall_s=rec["wall_s"])
            log(f"launch: dryrun {shape} {mesh_name}: "
                f"{summary['dryrun'][f'{shape} {mesh_name}']}")

    # (c) launch.train against an in-process fit of the same triple
    out = run_module("repro_torch.launch.train", (
        "--arch", "copml-logreg", "--workload", FULL_WORKLOAD, "--iters",
        str(FULL_ITERS)), "train")
    res = api.fit(FULL_WORKLOAD, "copml", "jit", iters=FULL_ITERS,
                  device="cuda")
    assert without_time(out.splitlines()[-1]) == \
        without_time(res.summary()), (out, res.summary())

    # (d) launch_counter over two jit steps, and profile_steps beside it
    wl = api.get_workload(FULL_WORKLOAD)
    proto = api.protocols.driver(wl, torch.device("cuda"))
    ops.reset_launches()
    cnt = launch_counter.count_steps(proto.iteration, res.state, 2)
    counts = run_counts()
    for name in FUSED_PATH:
        assert counts[name] > 0, f"{name} was not launched by the steps"
        assert counts[name] == cnt["launches"][name] * 2, (name, counts,
                                                            cnt["launches"])
    # a step's six draws, one threefry launch each
    assert counts["threefry"] == 6 * counts["fused_step"], counts
    samples = {"count_steps": [cnt], "profile_steps": []}
    for i in range(2 * IDLE_SAMPLES - 1):      # prof, cnt, cnt, prof, ...
        which = "profile_steps" if i % 4 in (0, 3) else "count_steps"
        samples[which].append(
            launch_counter.count_steps(proto.iteration, res.state, 2)
            if which == "count_steps"
            else profile_steps(torch, proto.iteration, res.state)[0])
    keys = ("wall_ms_per_step", "device_ms_per_step", "idle_share",
            "device_kernels_per_step")
    samples = {w: [{k: s[k] for k in keys} for s in got]
               for w, got in samples.items()}
    med = {w: {k: statistics.median(s[k] for s in got) for k in keys}
           for w, got in samples.items()}
    counted, prof = med["count_steps"], med["profile_steps"]
    assert abs(counted["device_kernels_per_step"]
               - prof["device_kernels_per_step"]) \
        <= 0.02 * prof["device_kernels_per_step"], (med, samples)
    assert abs(counted["idle_share"] - prof["idle_share"]) <= 0.05, \
        (med, samples)
    cfg = wl.cfg
    rf = cnt.roofline(f"copml/{FULL_WORKLOAD} jit step",
                      model_ops=roofline.copml_model_ops(
                          cfg.n_clients, wl.m, wl.d, cfg.k, cfg.t,
                          cfg.recovery_threshold))
    summary["launch_counter"] = dict(
        counted, **{k: cnt[k] for k in ("launches", "ops", "bytes")},
        rows=cnt["rows"], roofline=rf.to_dict(), profile_steps=prof,
        samples=samples)
    log(f"launch: launch_counter 2 jit steps: field kernels a step "
        f"{ {k: v for k, v in cnt['launches'].items() if v} }; medians of "
        f"{IDLE_SAMPLES} samples: device "
        f"{counted['device_kernels_per_step']:.1f} launches and "
        f"{counted['device_ms_per_step']:.3f} ms a step, idle "
        f"{counted['idle_share']:.3f} (profile_steps: "
        f"{prof['device_kernels_per_step']:.1f}, "
        f"{prof['device_ms_per_step']:.3f} ms, idle "
        f"{prof['idle_share']:.3f}); idle shares "
        f"{ {w: [round(x['idle_share'], 3) for x in got]
              for w, got in samples.items()} }; roofline {rf.to_dict()}")
    res.state = None
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"launch: phase 11 took {summary['seconds']:.1f} s")
    return summary, counts


# --------------------------------------------------------- phase 12: LM

def lm_params_gb(params: dict) -> float:
    return sum(t.numel() * t.element_size() for t in params.values()) / 1e9


def lm_frontier(torch, cfg, batch: int, gen, device):
    """Seeded stub frames / patches (B, n, d) in the config's type, or
    None for a family without a modality input."""
    from repro_torch.models import model_zoo
    fs = model_zoo._frontier_shape(cfg, batch)
    if fs is None:
        return None
    return (0.5 * torch.randn(fs, generator=gen, device=device)).to(
        cfg.torch_dtype)


def lm_decode_stepper(torch, cfg, params, batch: dict, cache_len: int):
    """(step, state) for launch_counter.profile_steps: generate's own
    greedy steps (lm_serving.prefill_into_cache, then decode_next).
    state = (caches, token (B, 1), pos, logits)."""
    from repro_torch.models import lm_serving
    scfg = lm_serving.ServeConfig(cache_len=cache_len)
    logits, caches, pos = lm_serving.prefill_into_cache(cfg, params, batch,
                                                        cache_len)

    def step(key, state):
        caches, tok, pos, _ = state
        nxt, caches, _, logits = lm_serving.decode_next(
            cfg, params, caches, tok, pos, scfg, None)
        return caches, nxt, pos + 1, logits

    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return step, (caches, tok, pos, logits)


def lm_corr(a, b) -> float:
    """Pearson correlation of two tensors' values, in float64 on the card."""
    a, b = a.double().flatten(), b.double().flatten()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def lm_bf16_vs_f32(ck: Checker, cfg, params, batch: dict,
                   cache_len: int) -> dict:
    """The main path's bf16 logits against float32 ones on the card, from
    the same weights widened and the same prompts: prefill's logits, and
    one decode step's of the bf16 prefill's greedy token.  Each must
    correlate >= LM_BF16_MIN_CORR."""
    torch = ck.torch
    from repro_torch.models import lm_serving, model_zoo
    runs, tok = {}, None
    for c, p in ((cfg, params),
                 (cfg.scaled(dtype="float32"),
                  {k: v.float() for k, v in params.items()})):
        logits, caches, pos0 = lm_serving.prefill_into_cache(c, p, batch,
                                                             cache_len)
        if tok is None:
            tok = torch.argmax(logits[:, -1], dim=-1).to(
                torch.int32)[:, None]
        dl, _ = model_zoo.build(c).decode_step(p, caches, tok, pos0)
        runs[c.dtype] = (logits.float(), dl.float())
        del p, caches
    (pb, db), (pf, df) = runs["bfloat16"], runs["float32"]
    rec = dict(prefill_corr=lm_corr(pb, pf), decode_corr=lm_corr(db, df),
               prefill_rel=lm_rel(pb, pf), decode_rel=lm_rel(db, df))
    log(f"lm: (a) bf16 against float32 on the card (same weights widened, "
        f"TF32 off): prefill logits corr {rec['prefill_corr']:.6f} "
        f"(max |diff| / max |f32| {rec['prefill_rel']:.3e}), one decode "
        f"step {rec['decode_corr']:.6f} ({rec['decode_rel']:.3e}); "
        f"min corr {LM_BF16_MIN_CORR}")
    assert min(rec["prefill_corr"], rec["decode_corr"]) >= LM_BF16_MIN_CORR, \
        rec
    return rec


def lm_serve(ck: Checker, cfg, params, run: dict, gen, what: str,
             phase_base: int, bf16_check: bool = False) -> dict:
    """generate() on the card at run's (batch, prompt, new, cache) after a
    two-token warm-up of the same shapes; the tokens' shape, range and
    prompt prefix checked; its peak memory above the phase's start
    (`phase_base` bytes allocated; the weights included) and above the
    call's start; a profile of two more decode steps (their logits
    finite); the prefill and decode-step bounds
    (launch/roofline.lm_*_work); with bf16_check, the same prompts' bf16
    logits against float32 ones (lm_bf16_vs_f32)."""
    torch = ck.torch
    from repro_torch.launch import launch_counter, roofline
    from repro_torch.models import lm_serving
    b, s0 = run["batch"], run["prompt"]
    cache = run["cache"] + (cfg.n_patches if cfg.family == "vlm" else 0)
    prompts = torch.randint(0, cfg.vocab, (b, s0), generator=gen,
                            device="cuda", dtype=torch.int32)
    frontier = lm_frontier(torch, cfg, b, gen, "cuda")
    lm_serving.generate(cfg, params, prompts, lm_serving.ServeConfig(
        max_new_tokens=2, cache_len=cache), frontier=frontier)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, stats = lm_serving.generate(
        cfg, params, prompts, lm_serving.ServeConfig(
            max_new_tokens=run["new"], cache_len=cache), frontier=frontier)
    peak = torch.cuda.max_memory_allocated()
    peak_gib = (peak - phase_base) / 2 ** 30
    call_gib = (peak - base) / 2 ** 30
    assert out.shape == (b, s0 + run["new"]) and out.is_cuda, out.shape
    assert torch.equal(out[:, :s0], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    del out
    batch = {"tokens": prompts}
    if frontier is not None:
        batch["frontier"] = frontier
    step, state = lm_decode_stepper(torch, cfg, params, batch, cache)
    prof, _, state = launch_counter.profile_steps(step, state, 2)
    assert bool(torch.isfinite(state[3].float()).all()), what
    del state, step
    f32_check = lm_bf16_vs_f32(ck, cfg, params, batch, cache) \
        if bf16_check else None
    pre_ms, pre_by = roofline.lm_bound(*roofline.lm_prefill_work(cfg, b, s0))
    dec_ms, dec_by = roofline.lm_bound(*roofline.lm_decode_work(cfg, b,
                                                                cache))
    rec = dict(
        arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model, d_ff=cfg.d_ff, heads=cfg.n_heads,
        kv_heads=cfg.n_kv, dtype=cfg.dtype, batch=b, prompt=s0,
        new=run["new"], cache=cache, params_gb=lm_params_gb(params),
        prefill_s=stats["prefill_s"], prefill_bound_ms=pre_ms,
        prefill_bound_by=pre_by,
        decode_ms_per_step=stats["decode_s"] / (run["new"] - 1) * 1e3,
        decode_bound_ms=dec_ms, decode_bound_by=dec_by,
        tokens_per_s=stats["tokens_per_s"], peak_gib=peak_gib,
        call_peak_gib=call_gib, bf16_vs_f32=f32_check,
        **{k: prof[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                "idle_share", "device_kernels_per_step")},
        top_kernels=sorted(
            ((k, v["device_ms"] / 2, v["count"] / 2)
             for k, v in prof["device_by_kernel"].items()),
            key=lambda r: -r[1])[:LM_TOP_KERNELS])
    log(f"lm: {what} {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"{cfg.dtype} B={b} S0={s0} new={run['new']} cache={cache}: "
        f"params {rec['params_gb']:.3f} GB; prefill "
        f"{rec['prefill_s'] * 1e3:.2f} ms (bound {pre_ms:.3f}, {pre_by}); "
        f"decode {rec['decode_ms_per_step']:.3f} ms a step (bound "
        f"{dec_ms:.4f}, {dec_by}); {rec['tokens_per_s']:.1f} tokens/s; "
        f"peak {peak_gib:.3f} GiB above the phase's start ({call_gib:.3f} "
        f"above the call's); profile of 2 steps: device "
        f"{prof['device_ms_per_step']} ms, idle {prof['idle_share']}, "
        f"{prof['device_kernels_per_step']} launches a step, wall "
        f"{prof['wall_ms_per_step']:.3f} ms; device ms and launches a step "
        f"by kernel: "
        + "; ".join(f"{k[:60]} {ms:.3f} x{n:g}"
                    for k, ms, n in rec["top_kernels"]))
    return rec


def lm_rel(got, want) -> float:
    """max |got - want| / max |want|, on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def lm_leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in lm_leaves(t)]
    return [tree]


def lm_property(ck: Checker, cfg, params, gen) -> float:
    """Prefill of LM_CHECK_S tokens then one decode step gives the full
    forward's logits at that position (float32, MoE at capacity 8).
    Returns max |decode - full| / max |full|."""
    torch = ck.torch
    from repro_torch.models import lm_serving, model_zoo
    b, s = LM_CHECK_B, LM_CHECK_S
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    frontier = lm_frontier(torch, cfg, b, gen, "cuda")
    bm = model_zoo.build(cfg)
    full, _ = bm.prefill_step(params, {"tokens": tokens,
                                       "frontier": frontier})
    _, caches, pos0 = lm_serving.prefill_into_cache(
        cfg, params, {"tokens": tokens[:, :s], "frontier": frontier},
        s + 8 + cfg.n_patches)
    dec, _ = bm.decode_step(params, caches, tokens[:, s:], pos0)
    err = lm_rel(dec[:, -1], full[:, -1])
    assert err <= LM_PROPERTY_TOL, (cfg.name, err)
    return err


def lm_card_vs_cpu(ck: Checker, cfg, params, gen) -> dict:
    """Prefill logits and caches, and one decode step's logits and caches,
    on the card and on the CPU from the same float32 weights and inputs.
    Returns the worst max |card - cpu| / max |cpu| of each."""
    torch = ck.torch
    from repro_torch.models import lm_serving, model_zoo
    b, s = LM_CHECK_B, LM_CHECK_S
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    frontier = lm_frontier(torch, cfg, b, gen, "cuda")
    bm = model_zoo.build(cfg)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else {k: v.cpu() for k, v in
                                          params.items()}
        batch = {"tokens": tokens[:, :s].to(dev)}
        if frontier is not None:
            batch["frontier"] = frontier.to(dev)
        logits, pc = bm.prefill_step(p, batch)
        pre = (logits, lm_leaves(pc))
        _, caches, pos0 = lm_serving.prefill_into_cache(
            cfg, p, batch, s + 8 + cfg.n_patches)
        dl, dc = bm.decode_step(p, caches, tokens[:, s:].to(dev), pos0)
        outs[dev] = (pre, (dl, lm_leaves(dc)))
        del p
    errs = {}
    for i, what in enumerate(("prefill", "decode")):
        (gl, gc), (wl, wc) = outs["cuda"][i], outs["cpu"][i]
        errs[f"{what}_logits"] = lm_rel(gl, wl)
        errs[f"{what}_caches"] = max(lm_rel(g, w) for g, w in zip(gc, wc))
    assert max(errs.values()) <= LM_CPU_TOL, (cfg.name, errs)
    return errs


def lm_sdpa_reference(ck: Checker, cfg) -> dict:
    """models/common.flash_attention against F.scaled_dot_product_attention
    at the main path's prefill shape (causal, GQA): the library's time,
    beside the port's, as a reference number only."""
    torch = ck.torch
    import torch.nn.functional as F
    from repro_torch.models import common
    b, s = LM_MAIN_RUN["batch"], LM_MAIN_RUN["prompt"]
    g = torch.Generator(device="cuda").manual_seed(3)

    def mk(h):
        return torch.randn((b, s, h, cfg.hd), generator=g, device="cuda",
                           dtype=cfg.torch_dtype)
    q, k, v = mk(cfg.n_heads), mk(cfg.n_kv), mk(cfg.n_kv)
    rep = cfg.n_heads // cfg.n_kv

    def port():
        return common.flash_attention(q, k, v, causal=True)

    def lib():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
            v.repeat_interleave(rep, 2).transpose(1, 2),
            is_causal=True).transpose(1, 2)
    err = lm_rel(port(), lib())
    rec = dict(shape=[b, s, cfg.n_heads, cfg.n_kv, cfg.hd],
               port_ms=ck.time_ms(port, 10), sdpa_ms=ck.time_ms(lib, 10),
               max_rel_diff=err)
    log(f"lm: flash_attention (port) vs scaled_dot_product_attention at "
        f"{rec['shape']} (B, S, Hq, Hkv, hd), causal, bf16: "
        f"{rec['port_ms']:.3f} vs {rec['sdpa_ms']:.3f} ms (CUDA events; "
        f"reference only), max |diff| / max |sdpa| {err:.2e}")
    return rec


def phase_lm(ck: Checker) -> dict:
    """LM serving on the card: (a) qwen3-1.7b at full width and depth
    through generate, (b) every other LM arch at its published widths
    with LM_DEPTH layers (float32 prefill-then-decode property, then bf16
    generate), (c) one arch a family, float32, card against CPU."""
    import gc
    torch = ck.torch
    from repro_torch.configs import registry
    from repro_torch.models import model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_base = torch.cuda.memory_allocated()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"runs": [], "property": {}, "card_vs_cpu": {}}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    # (a) the main path
    cfg = registry.get_config(LM_MAIN)
    params = model.init_params(cfg, gen(0), "cuda")
    out["runs"].append(lm_serve(ck, cfg, params, LM_MAIN_RUN, gen(1),
                                "(a) main path", phase_base,
                                bf16_check=True))
    out["sdpa_reference"] = lm_sdpa_reference(ck, cfg)
    del params
    # (b) every other arch at its widths, LM_DEPTH layers
    for arch in registry.LM_ARCH_IDS:
        depth = LM_DEPTH.get(arch, 2)
        cfg = registry.get_config(arch).scaled(n_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
        f32 = cfg.scaled(dtype="float32",
                         capacity_factor=8.0 if cfg.family == "moe"
                         else cfg.capacity_factor)
        params = model.init_params(f32, gen(0), "cuda")
        out["property"][arch] = lm_property(ck, f32, params, gen(2))
        if arch in LM_FAMILY_ARCHS:
            f32 = f32.scaled(capacity_factor=cfg.capacity_factor)
            out["card_vs_cpu"][arch] = lm_card_vs_cpu(ck, f32, params,
                                                      gen(4))
        del params
        log(f"lm: {arch} L={depth} float32: prefill-then-decode "
            f"{out['property'].get(arch)} (tol {LM_PROPERTY_TOL}); card vs "
            f"cpu {out['card_vs_cpu'].get(arch)} (tol {LM_CPU_TOL})")
        if arch == LM_MAIN:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init_params(cfg, gen(0), "cuda")
        out["runs"].append(lm_serve(ck, cfg, params, LM_OTHER_RUN, gen(1),
                                    "(b)", phase_base))
        del params
    assert set(out["card_vs_cpu"]) == set(LM_FAMILY_ARCHS)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm: phase 12 took {out['seconds']:.1f} s")
    return out


# -------------------------------------------------- phase 13: LM training

def lm_train_batch(torch, cfg, run: dict, gen, step: int = 0,
                   device="cuda") -> dict:
    """data/pipeline.lm_batch's batch `step` (seed 0) at run's (batch,
    seq), with a seeded frontier for a family that takes one."""
    from repro_torch.data import pipeline
    dcfg = pipeline.LmDataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                                 global_batch=run["batch"])
    batch = pipeline.lm_batch(dcfg, step, device=device)
    frontier = lm_frontier(torch, cfg, run["batch"], gen, device)
    if frontier is not None:
        batch["frontier"] = frontier
    return batch


def lm_state_gb(tree) -> float:
    if isinstance(tree, dict):
        return sum(lm_state_gb(v) for v in tree.values())
    return tree.numel() * tree.element_size() / 1e9


def lm_train(ck: Checker, cfg, run: dict, what: str, warm: int, timed: int,
             profile: bool, phase_base: int) -> dict:
    """train_step (adamw / the config's optimizer, in place) on the card at
    run's (batch, seq, loss_chunk) from init_params(seed 0), on
    lm_batch's stream: `warm` steps, then `timed` steps each ended by a
    device sync; the losses finite; ms a step, tokens/s, peak GiB above
    the phase's start, parameter and optimizer-state GB; with `profile`,
    launch_counter.profile_steps over two more steps (device ms, idle
    share, launches a step, the top kernels); the bound
    (roofline.lm_train_work)."""
    torch = ck.torch
    from repro_torch.launch import launch_counter, roofline
    from repro_torch.models import model_zoo
    gen = torch.Generator(device="cuda").manual_seed(0)
    bm = model_zoo.build(cfg, loss_chunk=run["loss_chunk"])
    params = bm.init_params(gen, device="cuda")
    opt_state = bm_opt(cfg).init(params)
    bgen = torch.Generator(device="cuda").manual_seed(1)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(warm + timed):
        batch = lm_train_batch(torch, cfg, run, bgen, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, met = bm.train_step(params, opt_state, batch,
                                               step)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses), (what, losses)
    step_ms = statistics.median(times[warm:]) * 1e3
    tokens = run["batch"] * run["seq"]
    ops, nbytes = roofline.lm_train_work(cfg, run["batch"], run["seq"],
                                         cfg.remat)
    bound_ms, bound_by = roofline.lm_bound(ops, nbytes)
    rec = dict(arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=cfg.dtype, optimizer=cfg.optimizer,
               remat=cfg.remat, **run, params_gb=lm_state_gb(params),
               opt_state_gb=lm_state_gb(opt_state), losses=losses,
               step_ms=step_ms, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=tokens / (step_ms / 1e3),
               peak_gib=(peak - phase_base) / 2 ** 30, ops=ops,
               bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)
    if profile:
        def step_fn(key, state):
            p, o, i = state
            b = lm_train_batch(torch, cfg, run, bgen, i)
            p, o, m = bm.train_step(p, o, b, i)
            assert math.isfinite(float(m["loss"]))
            return p, o, i + 1
        prof, _, _ = launch_counter.profile_steps(
            step_fn, (params, opt_state, warm + timed), 2)
        rec.update({k: prof[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "device_kernels_per_step")})
        rec["top_kernels"] = sorted(
            ((k, v["device_ms"] / 2, v["count"] / 2)
             for k, v in prof["device_by_kernel"].items()),
            key=lambda r: -r[1])[:LM_TOP_KERNELS]
    log(f"lm_train: {what} {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"{cfg.dtype} {cfg.optimizer} remat={cfg.remat} B={run['batch']} "
        f"S={run['seq']} loss_chunk={run['loss_chunk']}: params "
        f"{rec['params_gb']:.3f} GB, optimizer state "
        f"{rec['opt_state_gb']:.3f} GB; {step_ms:.2f} ms a step (median of "
        f"{timed} after {warm} warm-up; all "
        f"{[round(t, 2) for t in rec['step_ms_all']]}), "
        f"{rec['tokens_per_s']:.0f} tokens/s (bound {bound_ms:.3f} ms, "
        f"{bound_by}: {ops:.4e} ops, {nbytes:.4e} bytes); peak "
        f"{rec['peak_gib']:.3f} GiB above the phase's start; losses "
        f"{[round(x, 4) for x in losses]}"
        + ("" if not profile else
           f"; profile of 2 steps: device {rec['device_ms_per_step']} ms, "
           f"idle {rec['idle_share']}, {rec['device_kernels_per_step']} "
           f"launches a step, wall {rec['wall_ms_per_step']:.3f} ms; device "
           f"ms and launches a step by kernel: "
           + "; ".join(f"{k[:60]} {ms:.3f} x{n:g}"
                       for k, ms, n in rec["top_kernels"])))
    del params, opt_state
    return rec


def bm_opt(cfg):
    from repro_torch.optim import optimizers
    return optimizers.make(cfg.optimizer)


def lm_card_cpu_step(ck: Checker, cfg, run: dict, with_step: bool) -> dict:
    """train/card_check.card_cpu_step (loss_fn's gradients, and with
    `with_step` one train_step from a seeded optimizer state, card against
    CPU) from init_params(seed 0) and lm_batch's batch 0 at run's (batch,
    seq)."""
    torch = ck.torch
    from repro_torch.models import model
    from repro_torch.train import card_check
    p_cpu = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch_cpu = lm_train_batch(torch, cfg, run, torch.Generator(), 0, "cpu")
    return card_check.card_cpu_step(cfg, p_cpu, batch_cpu, with_step)


def lm_train_card_vs_cpu(ck: Checker, cfg) -> dict:
    """float32, TF32 off, card against CPU (lm_card_cpu_step), each within
    LM_CPU_TOL: at `cfg` (the published widths) loss_fn's loss and
    gradients; at the arch's SMOKE config one whole train_step (the
    optimizer's update over the published widths' ~0.1-0.6e9 parameters
    takes the CPU tens of seconds an arch).  At SMOKE the step with
    loss_chunk = LM_CHECK_S // 2, and (not an MoE) with microbatch = 1,
    must give its plain step's loss and gradient norm within
    LM_CPU_TOL."""
    torch = ck.torch
    from repro_torch.configs import registry
    from repro_torch.models import model, model_zoo
    run = dict(batch=LM_CHECK_B, seq=LM_CHECK_S)
    errs = lm_card_cpu_step(ck, cfg, run, with_step=False)
    sm = registry.smoke_config(cfg.name).scaled(dtype="float32")
    errs.update({f"smoke_{k}": v for k, v in
                 lm_card_cpu_step(ck, sm, run, with_step=True).items()})
    # microbatching and the chunked loss leave the step's loss and
    # gradient norm unchanged (SMOKE); an MoE's routing capacity and aux
    # loss are per microbatch (in the JAX package too), so its microbatched
    # step is another step and is not held to the plain one
    ps = model.init_params(sm, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    bs = lm_train_batch(torch, sm, run, torch.Generator(device="cuda")
                        .manual_seed(2), 0)
    variants = {"plain": {}, "loss_chunk": dict(loss_chunk=LM_CHECK_S // 2)}
    if sm.family != "moe":
        variants["microbatch"] = dict(microbatch=1)
    steps = {}
    for name, kw in variants.items():
        p = {k: v.clone() for k, v in ps.items()}
        _, _, met = model_zoo.build(sm, **kw).train_step(
            p, bm_opt(sm).init(p), bs, 0)
        steps[name] = met
    for name in variants:
        if name != "plain":
            errs[f"smoke_{name}"] = max(
                lm_rel(steps[name][k], steps["plain"][k])
                for k in ("loss", "grad_norm"))
    assert max(errs.values()) <= LM_CPU_TOL, (cfg.name, errs)
    return errs


LM_AGG_LEAVES = ("final_norm", "layers/attn_norm", "layers/mlp_norm",
                 "layers/wk")
# columns of the full-shape encode GEMM's check set to p - 1
LM_AGG_WORST = 1 << 20


def lm_train_secure(ck: Checker) -> dict:
    """train_secure (LM_SECURE) on the card, the field GEMM's launches by
    path counted over the run; then, on one step's client gradients
    restricted to LM_AGG_LEAVES (the CPU's threefry emulation takes
    minutes over all 63M), secure_aggregate on the card against the
    CPU's on copies: bit for bit.  The thin GEMM of the run's encode, at
    its full shape, equals its plain version (kernels/ref, on the card)
    bit for bit, and both are timed beside the bound."""
    torch = ck.torch
    from repro_torch.configs import registry
    from repro_torch.core import random as jrandom
    from repro_torch.core import secure_agg, shamir
    from repro_torch.data import pipeline
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import roofline
    from repro_torch.models import model_zoo
    from repro_torch.train import trainer
    run = LM_SECURE
    cfg = registry.get_config(run["arch"]).scaled(n_layers=run["layers"])
    sa = secure_agg.SecureAggConfig(n_clients=run["n"], t=run["t"])
    tcfg = trainer.TrainConfig(steps=run["steps"], global_batch=run["batch"],
                               seq_len=run["seq"], log_every=1,
                               secure_agg=sa)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = trainer.train_secure(cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = run_counts()
    assert counts["gemm:thin"] > 0, counts
    assert all(math.isfinite(h["loss"]) for h in hist), hist
    n_params = sum(v.numel() for v in params.values())
    # the bit-for-bit check on one step's gradients
    bm = model_zoo.build(cfg)
    dcfg = pipeline.LmDataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                                 global_batch=run["batch"])
    batch = pipeline.lm_batch(dcfg, 0, device="cuda")
    _, grads = trainer.client_grads(bm, params, batch, sa.n_clients)
    sub = [{k: g[k] for k in LM_AGG_LEAVES} for g in grads]
    del grads
    key = jrandom.fold_in(jrandom.PRNGKey(0), 0)
    got = secure_agg.secure_aggregate(key, sub, sa)
    want = secure_agg.secure_aggregate(
        key, [{k: v.cpu() for k, v in g.items()} for g in sub], sa)
    for k in LM_AGG_LEAVES:
        assert torch.equal(got[k].cpu(), want[k]), k
    agg_elems = sum(v.numel() for v in sub[0].values())
    # the thin GEMM of the run's encode: power matrix (N, T) @ the
    # coefficients (T, N x L), L the flat gradient's length
    pmat = shamir.power_matrix(shamir.default_eval_points(sa.n_clients),
                               sa.t, "cuda")
    coeffs = ck.field(sa.t, sa.n_clients * n_params)
    coeffs[:, :LM_AGG_WORST] = ck.P - 1    # the largest products
    gshape = f"({sa.n_clients},{sa.t})@({sa.t},{coeffs.shape[1]})"
    ops.reset_launches()                   # the check's and timing's launches
    ck.compare_on_card("modmatmul", mm.modmatmul(pmat, coeffs),
                       ref.modmatmul(pmat, coeffs),
                       f"train_secure encode {gshape}")
    gops, gbytes = roofline.gemm_work(tuple(pmat.shape), pmat.stride(),
                                      tuple(coeffs.shape), coeffs.stride())
    gbound, gby = bound(gbytes, gops)
    gms = ck.time_ms(lambda: mm.modmatmul(pmat, coeffs), 5)
    gdev = device_ms(torch, lambda: mm.modmatmul(pmat, coeffs), 3)
    gplain = ck.time_ms(lambda: ref.modmatmul(pmat, coeffs), 1)
    rec = dict(arch=cfg.name, layers=cfg.n_layers, n_clients=sa.n_clients,
               t=sa.t, steps=run["steps"], batch=run["batch"],
               seq=run["seq"], params=n_params, wall_s=wall,
               losses=[h["loss"] for h in hist], launches=counts,
               agg_check_elements=agg_elems,
               thin_gemm=dict(shape=[list(pmat.shape), list(coeffs.shape)],
                              ms=gms, device_ms=gdev, plain_ms=gplain,
                              bound_ms=gbound, bound_by=gby,
                              launches=counts["gemm:thin"], equal=True))
    log(f"lm_train: (d) train_secure {cfg.name} L={cfg.n_layers} "
        f"({n_params} parameters) N={sa.n_clients} T={sa.t}, "
        f"{run['steps']} steps of B={run['batch']} S={run['seq']}: "
        f"{wall:.2f} s, losses {rec['losses']}; launches {counts}; "
        f"secure_aggregate on the card equal to the CPU's bit for bit over "
        f"{agg_elems} gradient elements a client; thin GEMM {gshape} "
        f"equal to its plain version bit for bit: {gms:.4f} ms (CUDA "
        f"events), device "
        f"{'not measured' if gdev is None else f'{gdev:.4f}'} ms, plain "
        f"{gplain:.4f} ms (bound {gbound:.4f} ms, {gby}), "
        f"{counts['gemm:thin']} thin launches in the run")
    del params, coeffs, sub, got, want
    return rec


def lm_subprocesses(tmp: Path) -> dict:
    """launch.train with checkpoints (LM_RESUME): 6 steps, then the same
    command at 9 steps resumes; its last checkpoint's leaves equal a
    straight 9-step run's (trainer.train in this process).  launch.dryrun
    --arch LM_MAIN --shape all --mesh both ends with its success line and
    prints every cell."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models.config import applicable_shapes
    from repro_torch.train import checkpoint, trainer
    r = LM_RESUME
    base = ("--arch", "smollm-360m", "--batch", str(r["batch"]), "--seq",
            str(r["seq"]), "--ckpt-every", str(r["ckpt_every"]))
    t0 = time.perf_counter()
    run_module("repro_torch.launch.train",
               base + ("--steps", "6", "--ckpt", str(tmp / "resumed")),
               "train 6 steps")
    out = run_module("repro_torch.launch.train",
                     base + ("--steps", "9", "--ckpt", str(tmp / "resumed")),
                     "train resumed to 9 steps")
    assert "restored checkpoint, resuming at step 6" in out, out
    # the straight run in this process
    trainer.train(registry.smoke_config("smollm-360m"), trainer.TrainConfig(
        steps=9, global_batch=r["batch"], seq_len=r["seq"],
        ckpt_dir=str(tmp / "straight"), ckpt_every=r["ckpt_every"]),
        device="cuda")
    last = {}
    for d in ("resumed", "straight"):
        ck_ = checkpoint.Checkpointer(str(tmp / d))
        assert ck_.list_steps()[-1] == 8, (d, ck_.list_steps())
        path = tmp / d / "step_0000000008"
        last[d] = [np.load(f) for f in sorted(path.glob("leaf_*.npy"))]
    assert len(last["resumed"]) == len(last["straight"]) > 0
    for a, b in zip(last["resumed"], last["straight"]):
        np.testing.assert_array_equal(a, b)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run_module("repro_torch.launch.dryrun",
                     ("--arch", LM_MAIN, "--shape", "all", "--mesh", "both"),
                     "dry run")
    lines = out.splitlines()
    assert lines[-1] == "dry-run: all requested cells compiled", lines[-1]
    cfg = registry.get_config(LM_MAIN)
    cells = [ln for ln in lines if ln.startswith(f"--- {LM_MAIN} x ")]
    assert len(cells) == 2 * len(applicable_shapes(cfg)), cells
    assert sum(ln.startswith("executed:") for ln in lines) == len(cells)
    log(f"lm_train: (e) launch.train resumed at step 6 ends equal to a "
        f"straight 9-step run ({len(last['straight'])} leaves, bit for "
        f"bit), {train_s:.1f} s; launch.dryrun {LM_MAIN} printed "
        f"{len(cells)} cells, each with its executed SMOKE step, "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(resume_leaves=len(last["straight"]), train_s=train_s,
                dryrun_cells=len(cells), dryrun_lines=lines)


def phase_lm_train(ck: Checker) -> dict:
    """LM training on the card: (a) qwen3-1.7b at full width and depth,
    (b) every other LM arch at its published widths with LM_DEPTH layers,
    (c) one arch a family card vs CPU in float32, (d) train_secure, (e)
    launch.train's resume and launch.dryrun's LM cells in subprocesses."""
    import gc
    import tempfile
    torch = ck.torch
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    phase_base = torch.cuda.memory_allocated()
    out: dict = {"runs": [], "card_vs_cpu": {}, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now
    cfg = registry.get_config(LM_MAIN)
    main = lm_train(ck, cfg, LM_TRAIN_MAIN, "(a) main path", LM_TRAIN_WARM,
                    LM_TRAIN_TIMED, True, phase_base)
    assert main["losses"][-1] < main["losses"][0], main["losses"]
    out["runs"].append(main)
    part("(a)")
    for arch in registry.LM_ARCH_IDS:
        if arch == LM_MAIN:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get_config(arch).scaled(
            n_layers=LM_DEPTH.get(arch, 2))
        out["runs"].append(lm_train(ck, cfg, LM_TRAIN_OTHER, "(b)", 1, 1,
                                    False, phase_base))
    part("(b)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in LM_FAMILY_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get_config(arch).scaled(
            n_layers=LM_TRAIN_CHECK_DEPTH.get(arch, 1), dtype="float32")
        t0 = time.perf_counter()
        out["card_vs_cpu"][arch] = lm_train_card_vs_cpu(ck, cfg)
        log(f"lm_train: (c) {arch} L={cfg.n_layers} float32 card vs cpu "
            f"{out['card_vs_cpu'][arch]} (tol {LM_CPU_TOL}), "
            f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    part("(c)")
    gc.collect()
    torch.cuda.empty_cache()
    out["secure"] = lm_train_secure(ck)
    part("(d)")
    gc.collect()
    torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        out["subprocesses"] = lm_subprocesses(Path(tmp))
    part("(e)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm_train: phase 13 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in out["part_s"].items()) + ")")
    return out


def fit_full(ck: Checker, record=(), faults=None, workload=None,
             shape_log=None) -> tuple:
    """api.fit(workload, iters=FULL_ITERS) on the card, with the launch
    counts reset just before and read just after; the arguments of every
    call to the ops entries named in `record` are kept.  Returns (result,
    counts, calls, peak bytes the fit allocated above what was held when it
    started)."""
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


def phase_faulty(ck: Checker, np, fused) -> dict:
    """cifar10_case2 at full width under a fault plan: a straggler at
    step 1 and an adversary from step 3, which leaves exactly R = 49 of the
    50 clients available."""
    from repro_torch.launch.launch_counter import LaunchLog
    from repro_torch import api
    wl = api.get_workload(FULL_WORKLOAD)
    plan = api.FaultPlan.from_schedule(wl.n_clients, FULL_ITERS,
                                       stragglers={1: (0,)},
                                       adversaries={3: (7,)})
    headroom = plan.validate(api.fault_threshold(wl))
    log(f"faulty: {plan.describe()}, headroom per step {headroom.tolist()}")
    shapes = LaunchLog()
    res, counts, calls, peak = fit_full(
        ck, record=("fused_step",), faults=plan, shape_log=shapes)
    same_model(np, res, fused, "faulty vs fault-free")
    offsets = [args[3].cpu() for args, _ in calls["fused_step"]]
    assert len(offsets) == FULL_ITERS
    for step, off in enumerate(offsets):
        hit = (off != 0).nonzero().flatten().tolist()
        assert hit == ([7] if step >= 3 else []), (step, hit)
    res.state = None
    del calls
    out = run_summary(res, counts, peak)
    out["gemm_shapes"] = gemms = gemm_table(ck, shapes, FULL_ITERS)
    log_gemm_table("faulty", gemms)
    no_tiled_gemm(gemms)
    log(f"faulty: weights and history equal the fault-free run's; "
        f"{out['ms_per_iter']:.3f} ms/iter, launches {counts}")
    return out


# (label, kernel, A or x shape, B or W shape, C): the redesigned kernels at
# ----------------------------------------------- phase 14: the wide route

def wide_workloads() -> tuple:
    """cifar10_case2's configuration (N = 50, K = 10, T = 7, r = 1, its eta
    raised by _field_safe_cfg's rule for m = WIDE_M) at d = WIDE_D:
    binary and ten-class one-vs-rest, registered through api.workloads."""
    import dataclasses
    from repro_torch import api
    from repro_torch.api.workloads import _field_safe_cfg
    from repro_torch.configs import copml_logreg
    from repro_torch.core import objectives
    cfg = _field_safe_cfg(copml_logreg.WORKLOADS[FULL_WORKLOAD].cfg, WIDE_M,
                          WIDE_NAME)
    wl = api.workloads.register(api.Workload(
        WIDE_NAME, m=WIDE_M, d=WIDE_D, cfg=cfg, iters=FULL_ITERS),
        replace=True)
    wl10 = api.workloads.register(dataclasses.replace(
        wl, name=WIDE10_NAME, objective=objectives.get("ovr10")),
        replace=True)
    return wl, wl10


def worst_rows(ck: Checker, x, w) -> None:
    """Rows at p - 1: x's first client and every client's last row, w's
    first client."""
    x[0] = ck.P - 1
    x[:, -1] = ck.P - 1
    w[0] = ck.P - 1


def timed_row(ck: Checker, name: str, what: str, fn, plain, work: tuple,
              reps: int = 10) -> dict:
    """CUDA-event and device ms of `fn`, its plain version's ms, and the
    bound of `work` (operations, bytes); kept in ck.rows."""
    torch = ck.torch
    ms_ = ck.time_ms(fn, reps)
    dev_ = device_ms(torch, fn, reps)
    pl_ = ck.time_ms(plain, 2)
    bb_, by_ = bound(work[1], work[0])
    rec = dict(shape=what, ms=ms_, device_ms=dev_, plain_ms=pl_,
               bound_ms=bb_, bound_by=by_)
    ck.rows.append(dict(kernel=name, what=what, **rec))
    log(f"wide: {name} {what}: {ms_:.4f} ms, device "
        f"{'not measured' if dev_ is None else f'{dev_:.4f} ms'}, plain "
        f"{pl_:.3f} ms, bound {bb_:.4f} ms ({by_})")
    return rec


def cluster_label(m: int, d: int, k=None) -> str:
    from repro_torch.kernels import plan
    pl = plan.cluster_plan(m, d, 1, k)
    return (f"[k={pl['k']} cw={pl['cw']} bm={pl['bm']} "
            f"stages={pl['stages']} {pl['mode']}]")


def cluster_checks(ck: Checker, n: int, mk: int, d: int) -> None:
    """The cluster route (C = 1) against its plain version (kernels/ref on
    the card): at the wide cell's (N, m, d) with rows at p - 1 and with
    every operand p - 1, at odd d = 58,005 (rows 4-byte aligned), at its
    widest d with N = 2, m = 3, at m = 2 (below the slice of m = 156) and
    with one client; through coded_gradient_matrix and _batched."""
    torch = ck.torch
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import plan, ref
    cases = [(n, mk, d, "rows at p - 1"), (n, mk, d, "every operand p - 1"),
             (n, mk, 58005, "odd d, rows at p - 1"),
             (2, 3, plan.cluster_max_d(), "the cluster's widest d"),
             (n, 2, d, "m = 2, below one slice"), (1, mk, d, "one client")]
    for nn, m_, d_, what in cases:
        assert plan.gradient_route(d_, 1) == "cluster", (d_, what)
        x, w, co = ck.field(nn, m_, d_), ck.field(nn, d_, 1), ck.field(2)
        if what.startswith("every"):
            for t in (x, w, co):
                t.fill_(ck.P - 1)
        else:
            worst_rows(ck, x, w)
        label = (f"cluster N={nn} m={m_} d={d_} C=1 "
                 f"{cluster_label(m_, d_)}: {what}")
        want = ref.coded_gradient_matrix(x, w, co)
        ck.compare("fused_step.cluster", cg.coded_gradient_matrix(x, w, co),
                   want, label)
        ck.compare("coded_gradient_batched",
                   cg.coded_gradient_batched(x, w[..., 0], co),
                   want[..., 0], label)
        del x, w, co, want
        torch.cuda.empty_cache()
    log(f"wide: the cluster route equals its plain version at "
        f"{len(cases)} shapes")


def wide_kernel_rows(ck: Checker, n: int, mk: int, d: int) -> dict:
    """The routes past d = 58,004 at the wide cell's shape, X~ (N, m, d) =
    (50, 156, 65,536), against their plain versions (kernels/ref on the
    card) and timed beside their bounds: the cluster route at C = 1
    (cluster_checks, then its gradient at each cluster size and the fused
    step on it), the two-read route at C = 1 by direct calls (before the
    cluster route took it), C = 10 on the route the plan gives it, and
    each of the wide route's four kernels at the ten-class fits' shapes.  Returns the kernels-line rows
    (the cluster kernel's at C = 1, the wide route's at C = 10)."""
    torch = ck.torch
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import field_poly as fp
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import modmatmul as mm
    from repro_torch.kernels import plan, ref
    from repro_torch.launch import roofline as RL
    cluster_checks(ck, n, mk, d)
    rows = {}

    # (a) the cluster gradient at C = 1: every cluster size that fits,
    #     then the plan's
    x, w, co = ck.field(n, mk, d), ck.field(n, d, 1), ck.field(2)
    want = ref.coded_gradient_matrix(x, w, co)
    sizes = {}
    for k in plan.CLUSTER_SIZES:
        try:
            label = cluster_label(mk, d, k)
        except ValueError:
            continue                           # no slice fits at this k
        ck.compare("fused_step.cluster", cg.cluster_gradient(x, w, co, k=k),
                   want, f"cluster N={n} m={mk} d={d} C=1 {label}")
        sizes[k] = device_ms(
            torch, lambda: cg.cluster_gradient(x, w, co, k=k), 10)
        ck.rows.append(dict(kernel="fused_step.cluster",
                            what=f"cluster size {k}", shape=label,
                            device_ms=sizes[k],
                            clusters=cg.cluster_args("coded_gradient", n, mk,
                                                     d, 1, k)[-1]))
    log(f"wide: cluster gradient N={n} m={mk} d={d} C=1 device ms by "
        f"cluster size {sizes}; the plan takes {cluster_label(mk, d)}, "
        f"{cg.cluster_args('coded_gradient', n, mk, d, 1)[-1]} clusters")
    rows["fused_step.cluster"] = dict(timed_row(
        ck, "fused_step.cluster",
        f"cluster gradient N={n} m={mk} d={d} C=1 {cluster_label(mk, d)}",
        lambda: cg.coded_gradient_matrix(x, w, co),
        lambda: ref.coded_gradient_matrix(x, w, co),
        RL.gradient_work(n, mk, d, 1, 1)), workload=WIDE_NAME)
    ck.compare("coded_gradient_matrix", cg.wide_gradient(x, w, co), want,
               f"wide route N={n} m={mk} d={d} C=1, called directly")
    timed_row(ck, "coded_gradient_matrix",
              f"wide route N={n} m={mk} d={d} C=1, called directly",
              lambda: cg.wide_gradient(x, w, co),
              lambda: ref.coded_gradient_matrix(x, w, co),
              RL.gradient_work(n, mk, d, 1, 1), reps=5)
    del x, w, co, want
    torch.cuda.empty_cache()

    # (b) the fused step on the cluster route, and on the two-read route
    op = fused_operands(ck, n, mk, d, 1, 1)
    args, kw = op["args"], op["kw"]
    worst_rows(ck, *args[:2])
    what = f"N={n} m={mk} d={d} C=1"
    got = fs.fused_step(*args, **kw)
    want = ref.fused_step(*args, **kw)
    for g, w_, part in zip(got, want, ("f", "new_w")):
        ck.compare("fused_step", g, w_, f"{what} rows at p - 1 {part}")
    del got, want
    timed_row(ck, "fused_step", f"{what} (the whole step, cluster route)",
              lambda: fs.fused_step(*args, **kw),
              lambda: ref.fused_step(*args, **kw),
              RL.fused_work(n, mk, d, 1, 1), reps=10)
    x, w, co = args[:3]
    timed_row(ck, "fused_step", f"{what} (the whole step, two-read route "
              f"called directly)",
              lambda: fs.epilogue(cg.wide_gradient(x, w, co), *args[3:],
                                  **kw),
              lambda: ref.fused_step(*args, **kw),
              RL.fused_work(n, mk, d, 1, 1), reps=5)
    del op, args, x, w, co
    torch.cuda.empty_cache()

    # (c) ten classes, on the route the plan gives them (the wide one: the
    #     cluster kernel takes C = 1 only)
    route = plan.gradient_route(d, 10)
    for worst in (False, True):
        x, w, co = ck.field(n, mk, d), ck.field(n, d, 10), ck.field(2)
        if worst:
            for t in (x, w, co):
                t.fill_(ck.P - 1)
        else:
            worst_rows(ck, x, w)
        label = (f"N={n} m={mk} d={d} C=10 "
                 f"{'every operand' if worst else 'rows at'} p - 1")
        want = ref.coded_gradient_matrix(x, w, co)
        ck.compare("coded_gradient_matrix",
                   cg.coded_gradient_matrix(x, w, co), want,
                   f"{label}, {route} route")
        if not worst:
            timed_row(ck, "coded_gradient_matrix", f"{label}, {route} route",
                      lambda: cg.coded_gradient_matrix(x, w, co),
                      lambda: ref.coded_gradient_matrix(x, w, co),
                      RL.gradient_work(n, mk, d, 10, 1), reps=5)
        del x, w, co, want
        torch.cuda.empty_cache()

    # (d) the wide route's four kernels at the ten-class fits' shapes
    op = fused_operands(ck, n, mk, d, 10, 1)
    args, kw = op["args"], op["kw"]
    x, w, co = args[:3]
    worst_rows(ck, x, w)
    what = f"N={n} m={mk} d={d} C=10"
    xt = x.transpose(1, 2)
    z = mm.modmatmul_batched(x, w)
    assert mm.path_of(x, w) == "rowdot" and mm.path_of(xt, z) == "colsum"
    ck.compare("fused_step.wide_z", z, ref.modmatmul_batched(x, w), what)
    g = fp.poly_eval(z, co)
    ck.compare("fused_step.wide_ghat", g, ref.poly_eval(z, co), what)
    f = mm.modmatmul_batched(xt, g)
    ck.compare("fused_step.wide_xtg", f, ref.modmatmul_batched(xt, g), what)
    new_w = fs.epilogue(f, *args[3:], **kw)
    ck.compare("fused_step.wide_epilogue", new_w,
               ref.fused_epilogue(f, *args[3:], **kw), what)
    el = n * d * 10
    epi_work = (RL.OPS_PER_FIELD_MAC * 4 * el, 4.0 * (7 * el + 3 * n))
    rows["fused_step.wide_z"] = timed_row(
        ck, "fused_step.wide_z", f"Z = X~ W~ {tuple(x.shape)}@"
        f"{tuple(w.shape)}, rowdot", lambda: mm.modmatmul_batched(x, w),
        lambda: ref.modmatmul_batched(x, w),
        RL.gemm_work(x.shape, x.stride(), w.shape, w.stride()))
    rows["fused_step.wide_ghat"] = timed_row(
        ck, "fused_step.wide_ghat", f"ghat(Z) L={z.numel()} degree 1",
        lambda: fp.poly_eval(z, co), lambda: ref.poly_eval(z, co),
        RL.poly_work(z.numel(), 1), reps=20)
    rows["fused_step.wide_xtg"] = timed_row(
        ck, "fused_step.wide_xtg", f"X~^T ghat {tuple(xt.shape)}@"
        f"{tuple(g.shape)}, colsum", lambda: mm.modmatmul_batched(xt, g),
        lambda: ref.modmatmul_batched(xt, g),
        RL.gemm_work(xt.shape, xt.stride(), g.shape, g.stride()))
    rows["fused_step.wide_epilogue"] = timed_row(
        ck, "fused_step.wide_epilogue", f"epilogue N={n} d={d} C=10",
        lambda: fs.epilogue(f, *args[3:], **kw),
        lambda: ref.fused_epilogue(f, *args[3:], **kw), epi_work, reps=20)
    for name in WIDE_ENTRIES:
        if name != "fused_step.cluster":
            rows[name] = dict(rows[name], workload=WIDE10_NAME)
    del op, args, x, w, co, xt, z, g, f, new_w
    torch.cuda.empty_cache()
    return rows


def wide_counts_ok(counts: dict, iters: int, fused: bool, route: str,
                   what: str = "") -> None:
    """The run's route past d = 58,004 ran once a step -- the cluster
    kernel, or the wide route (with the fused step's epilogue when
    `fused`) -- the other never, and the gradient kernels' body never; no
    GEMM took the tiled kernel."""
    cluster = route == "cluster"
    assert counts["wide:cluster"] == (iters if cluster else 0), \
        (what, counts)
    assert counts["wide:gradient"] == (0 if cluster else iters), \
        (what, counts)
    assert counts["wide:epilogue"] == (iters if fused and not cluster
                                       else 0), (what, counts)
    for name in ("fused_step", "coded_gradient_batched",
                 "coded_gradient_matrix", "coded_gradient"):
        assert counts[name] == 0, (what, name, counts)
    assert counts["gemm:tiled"] == 0, (what, counts)
    if not cluster:
        assert counts["gemm:rowdot"] >= iters and \
            counts["gemm:colsum"] >= iters, (what, counts)


def profile_top(step, state, top: int = 8) -> dict:
    """Two steps from `state` under torch.profiler
    (launch_counter.profile_steps): wall and device ms a step, idle share,
    kernels a step, and the `top` kernels by device ms over the two
    steps."""
    from repro_torch.launch import launch_counter
    summary, _, _ = launch_counter.profile_steps(step, state)
    by_kernel = sorted(summary.pop("device_by_kernel").items(),
                       key=lambda kv: -kv[1]["device_ms"])
    return dict(summary, top_kernels=[
        dict(name=k[:80], **v) for k, v in by_kernel[:top]])


def phase_wide(ck: Checker, np) -> tuple:
    """The coded gradient past d = 58,004: its kernels at the full shape,
    then api.fit of the wide workloads (d = 65,536) on the card, binary
    (the cluster route) and ten-class (the wide route; FULL_ITERS each),
    and sharded:4 (WIDE_SHARDED_ITERS, against jit), the last steps
    re-checked, two binary and two ten-class steps profiled, and the
    binary result served at WIDE_SERVE_BATCH (the split-K GEMM at
    K = 65,536).  Returns (the kernels-line rows, summary, launch counts by
    run)."""
    torch = ck.torch
    from repro_torch import api
    from repro_torch.core import meshutil
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ops, plan, ref
    from repro_torch.serve import coded
    t_phase = time.perf_counter()
    wl, wl10 = wide_workloads()
    mk = -(-wl.m // wl.cfg.k)
    route, route10 = plan.gradient_route(wl.d, 1), plan.gradient_route(wl.d,
                                                                       10)
    assert route == "cluster", route
    torch.cuda.empty_cache()
    rows = wide_kernel_rows(ck, wl.n_clients, mk, wl.d)
    log(f"wide: kernels at the full shape equal their plain versions "
        f"{dict(ck.checks)}")

    # (a) fused, with the last step's operands re-checked
    res, counts, calls, peak = fit_full(ck, record=("fused_step",),
                                        workload=WIDE_NAME)
    args, kw = calls["fused_step"][-1]
    assert tuple(args[0].shape) == (wl.n_clients, mk, wl.d), args[0].shape
    got = fs.fused_step(*args, **kw)
    want = ref.fused_step(*args, **kw)
    for g, w_, part in zip(got, want, ("f", "new_w")):
        ck.compare("fused_step", g, w_, f"{WIDE_NAME} last step {part}")
    del calls, args, kw, got, want
    wide_counts_ok(counts, FULL_ITERS, True, route, "fused")
    weights = np.asarray(res.weights)
    assert weights.shape == (wl.d,) and np.isfinite(weights).all()
    summary = {"fused": run_summary(res, counts, peak)}
    proto = api.protocols.driver(wl, torch.device("cuda"))
    summary["fused"]["profiled_steps"], summary["fused"]["profile"] = \
        profile_steps(torch, proto.iteration, res.state)
    log(f"wide: {WIDE_NAME} fused N={wl.n_clients} m={wl.m} d={wl.d} setup "
        f"{summary['fused']['setup_s']:.3f} s, "
        f"{summary['fused']['ms_per_iter']:.3f} ms/iter, peak "
        f"{summary['fused']['peak_gib']:.2f} GiB, accuracy "
        f"{res.final_accuracy:.4f}; launches {counts}")
    log(f"wide: profiled steps {summary['fused']['profiled_steps']}")

    # (b) serving the fused result
    q = np.asarray(wl.eval_set()[0][:WIDE_SERVE_QUERIES], np.float32)
    want = coded.reference_scores(res.weights, q, wl.cfg,
                                  device="cpu").numpy()
    srv = api.serve(wl, res, "jit", batch_size=WIDE_SERVE_BATCH,
                    device="cuda")
    assert srv.model.from_shares
    got = np.concatenate([srv.score_field(q[i:i + WIDE_SERVE_BATCH])
                          for i in range(0, len(q), WIDE_SERVE_BATCH)])
    np.testing.assert_array_equal(got, want, err_msg="wide serving")
    ops.reset_launches()
    preds, stats = srv.serve(q)
    serve_counts = run_counts()
    assert serve_counts["gemm:splitk"] == stats["batches"], serve_counts
    assert serve_counts["gemm:tiled"] == 0, serve_counts
    xb = torch.from_numpy(q[:WIDE_SERVE_BATCH]).cuda()
    summary["serve"] = dict(
        batch=WIDE_SERVE_BATCH, queries=stats["queries"],
        queries_per_s=stats["queries_per_s"], encode_s=stats["encode_s"],
        device_ms_per_window=device_ms(torch, lambda: srv._score(xb), 20),
        launches=serve_counts)
    log(f"wide: serve {WIDE_NAME} batch {WIDE_SERVE_BATCH}: every window "
        f"equal to reference_scores; {stats['queries_per_s']:.0f} "
        f"queries/s; window device ms "
        f"{summary['serve']['device_ms_per_window']}; launches "
        f"{serve_counts}")
    del srv, xb

    res.state = None
    torch.cuda.empty_cache()

    # (c) ten classes (the wide route's epilogue), with the last step's
    # operands re-checked and two more steps profiled
    fres, fcounts, fcalls, fpeak = fit_full(ck, record=("fused_step",),
                                            workload=WIDE10_NAME)
    args, kw = fcalls["fused_step"][-1]
    got = fs.fused_step(*args, **kw)
    want = ref.fused_step(*args, **kw)
    for g, w_, part in zip(got, want, ("f", "new_w")):
        ck.compare("fused_step", g, w_, f"{WIDE10_NAME} last step {part}")
    del fcalls, args, kw, got, want
    wide_counts_ok(fcounts, FULL_ITERS, True, route10, "ten-class fused")
    mw = np.asarray(fres.weights)
    assert mw.shape == (wl.d, 10) and np.isfinite(mw).all()
    summary["fused C=10"] = run_summary(fres, fcounts, fpeak)
    proto10 = api.protocols.driver(wl10, torch.device("cuda"))
    summary["fused C=10"]["profile"] = profile_top(proto10.iteration,
                                                   fres.state)
    log(f"wide: {WIDE10_NAME} fused "
        f"{summary['fused C=10']['ms_per_iter']:.3f} ms/iter, peak "
        f"{summary['fused C=10']['peak_gib']:.2f} GiB, accuracy "
        f"{fres.final_accuracy:.4f}; launches {fcounts}")
    log(f"wide: {WIDE10_NAME} fused, two steps profiled: "
        f"{summary['fused C=10']['profile']}")
    fres.state = None
    torch.cuda.empty_cache()

    # (d) sharded:4 against jit
    mesh = meshutil.client_mesh(SHARDED_N, "cuda")
    api.fit("smoke", "copml", mesh, iters=1, history=False, device="cuda")
    jres = api.fit(wl, "copml", "jit", key=0, iters=WIDE_SHARDED_ITERS,
                   device="cuda")
    shres, shcounts, shpeak = fit_sharded(ck, wl, SHARDED_ENGINE,
                                          WIDE_SHARDED_ITERS)
    same_state(np, shres, jres, f"wide {SHARDED_ENGINE} vs jit")
    sharded_ranks_ok(shres, WIDE_SHARDED_ITERS, route, mesh)
    summary[SHARDED_ENGINE] = dict(run_summary(shres, shcounts, shpeak),
                                   ranks=shres.timings["ranks"])
    log(f"wide: {SHARDED_ENGINE} {WIDE_SHARDED_ITERS} steps bit-equal to "
        f"jit; {summary[SHARDED_ENGINE]['ms_per_iter']:.3f} ms/iter; "
        f"launches {shcounts}")
    jres.state = shres.state = None
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"wide: phase 14 took {summary['phase_s']:.1f} s")
    runs = {f"fused {WIDE_NAME}": counts, f"fused {WIDE10_NAME}": fcounts,
            f"{SHARDED_ENGINE} {WIDE_NAME}": shcounts}
    return rows, summary, runs


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
    ("sharded rank scores, batch 1", "modmatmul", (1, 3073), (3073, 13), 0),
    ("sharded rank scores, batch 32", "modmatmul", (32, 3073), (3073, 13), 0),
    ("sharded rank scores, batch 128", "modmatmul", (128, 3073), (3073, 13),
     0),
    # past d = 58,004: the cluster route here, the wide route before
    ("fused_step wide d=65536", "fused_step", (50, 156, 65536), None, 1),
    ("coded_gradient_batched wide d=65536", "coded_gradient_batched",
     (50, 156, 65536), None, 1),
    ("coded_gradient_matrix wide d=65536 C=10", "coded_gradient_matrix",
     (50, 156, 65536), None, 10),
    # (label, "poly_eval", (L,), None, degree)
    ("poly_eval L=45100 degree 1", "poly_eval", (45100,), None, 1),
    ("poly_eval L=2^26 degree 1", "poly_eval", (1 << 26,), None, 1),
    ("poly_eval L=2^26 degree 7", "poly_eval", (1 << 26,), None, 7),
]


# phase 15: the threefry kernel.  The six draws of a cifar10_case2 step
# (T = 7, N = 50, d = 3,073: the model encode's v and its Shamir
# coefficients, the masks' mix, TruncPr's r and the coefficients of [r] and
# [r0]; span None: the field's p, else TruncPr's 2^k2) and set-up's
# largest, X's Shamir coefficients
THREEFRY_STEP = [((7, 3073), None), ((7, 7, 3073), None),
                 ((7, 50, 3073), None), ((3073,), 1 << 25), ((7, 3073), None),
                 ((7, 3073), None)]
THREEFRY_SETUP = (7, 9019, 3073)
THREEFRY_MIX = (7, 50, 3073)


def threefry_work(n: int, bits: bool = False) -> tuple:
    """(operations, bytes) of one draw of n words: the integer ALU pipe's
    kernels/threefry.py ALU_OPS_PAIR a counter pair and, for randint, one
    a word for the reduction; each word written once (4 bytes, or 8 for
    bits32)."""
    from repro_torch.kernels import threefry
    pairs = (n + 1) // 2
    ops = pairs * threefry.ALU_OPS_PAIR + (0 if bits else n)
    return ops, n * (8 if bits else 4)


def threefry_sass() -> dict | None:
    """Opcodes of the built threefry kernel by instantiation (its Mode:
    0 bits32, 1 a power-of-two span, 2 the multiply-high reduction, 3 with
    the hi hash), from cuobjdump -sass; None where no cuobjdump is."""
    from repro_torch.kernels import build
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(build._lib_path(
        "threefry"))], capture_output=True, text=True, check=True).stdout
    out, mode = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            mode = line.split("threefry_kernelILi")[1][0]
            out[mode] = collections.Counter()
        elif mode is not None and line.startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].strip()
            if ins.startswith("@"):
                ins = ins.split(None, 1)[1]
            op = ins.split(None, 1)[0].split(".")[0].rstrip(";") if ins \
                else ""
            if op.isupper():
                out[mode][op] += 1
    return {m: dict(c) for m, c in out.items()}


def threefry_entry(ck: Checker, rows: dict, launches: int, path: str,
                   by_path: dict) -> dict:
    """The threefry kernel's kernels-line entry: its launches on `path`
    (and by path), its comparisons, and set-up's draw timed."""
    assert launches > 0, f"the threefry kernel was not launched on {path}"
    r = rows["setup"]
    return dict(
        name="threefry", route="cuda",
        source="src/repro_torch/kernels/csrc/threefry.cu", replaces=None,
        launches=launches, path=path, launches_by_path=by_path,
        max_abs_err=ck.max_err["threefry"],
        equal=ck.max_err["threefry"] == 0, checks=ck.checks["threefry"],
        shape=r["shape"], ms=r["ms"], device_ms=r["device_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None, proc_worker=None)


def phase_threefry(ck: Checker) -> dict:
    """Phase 15 (the module docstring); returns its details, with the
    launches of one step's six draws under "step_six_draws_launches"."""
    from repro_torch.core import field
    from repro_torch.core import random as jrandom
    from repro_torch.kernels import ops, threefry
    torch, P = ck.torch, ck.P
    cuda = torch.device("cuda")
    step = [(s, P if span is None else span) for s, span in THREEFRY_STEP]

    def one_launch(entry, launches=1):
        counts = ops.threefry_counts()
        want = {e: launches if e == entry else 0 for e in threefry.ENTRIES}
        assert counts == want, (entry, counts)

    cases = [(s, 0, span) for s, span in step] + [
        ((7,), 0, P), ((4097,), 0, 1 << 24), ((5, 3), 0, 1000),
        ((1001,), -(1 << 31), (1 << 31) - 1), ((9,), 3, 4)]
    for i, (shape, lo, hi) in enumerate(cases):
        key = jrandom.fold_in(jrandom.PRNGKey(29), i)
        ops.reset_launches()
        got = jrandom.randint(key, shape, lo, hi, device=cuda)
        one_launch("randint")
        ck.compare("threefry", got, jrandom.randint(key, shape, lo, hi),
                   f"randint {shape} [{lo}, {hi})")
    for k, shape, span in ((3, (7, 5), P), (3, (3, 4), 1000),
                           (70, (1001,), P)):
        keys = jrandom.split(jrandom.PRNGKey(5), k)
        ops.reset_launches()
        got = jrandom.randint_keys(keys, shape, 0, span, device=cuda)
        one_launch("randint_keys", -(-k // threefry.MAX_ROWS))
        ck.compare("threefry", got,
                   jrandom.randint_keys(keys, shape, 0, span),
                   f"randint_keys {k} x {shape} span {span}")
    for shape in ((1,), (7,), (4097,), (3, 5)):
        key = jrandom.PRNGKey(23)
        ops.reset_launches()
        got = jrandom.bits32(key, shape, device=cuda)
        one_launch("bits32")
        ck.compare("threefry", got, jrandom.bits32(key, shape),
                   f"bits32 {shape}")

    # set-up's draw against the plain version on the card
    key = jrandom.fold_in(jrandom.PRNGKey(3), 1)
    n_setup = math.prod(THREEFRY_SETUP)
    halves = [jrandom._words(k) for k in jrandom.split(key)]
    ops.reset_launches()
    got = field.random_field(key, THREEFRY_SETUP, cuda)
    one_launch("randint")
    want = jrandom._draw_plain(*halves, n_setup, 0, P, 0, cuda, None)
    ck.compare_on_card("threefry", got.reshape(-1), want,
                       f"randint {THREEFRY_SETUP}")
    del got, want

    rows = {}
    for label, shape in (("setup", THREEFRY_SETUP), ("mix", THREEFRY_MIX)):
        n = math.prod(shape)
        out = torch.empty(n, dtype=torch.int32, device=cuda)
        span_ = threefry.mod_constants(P)

        def kern(n=n, out=out):
            threefry._launch(out, "randint", [*halves[1], *halves[0]],
                             span_[0], n, P, span_[1], 0, 0)

        def plain(n=n):
            jrandom._draw_plain(*halves, n, 0, P, 0, cuda, None)

        ms_ = ck.time_ms(kern, 10 if label == "setup" else 200)
        dev_ = device_ms(torch, kern, 10 if label == "setup" else 50)
        pl_ = ck.time_ms(plain, 2 if label == "setup" else 10)
        work = threefry_work(n)
        bb_, by_ = bound(work[1], work[0])
        rows[label] = dict(shape=str(shape), words=n, ms=ms_,
                           device_ms=dev_, plain_ms=pl_, bound_ms=bb_,
                           bound_by=by_, ops=work[0], bytes=work[1])
        ck.rows.append(dict(kernel="threefry", what=f"randint {shape}",
                            **rows[label]))
        log(f"threefry: randint {shape} ({n:,} words): {ms_:.4f} ms, "
            f"device {'not measured' if dev_ is None else f'{dev_:.4f} ms'}"
            f", plain {pl_:.3f} ms, bound {bb_:.4f} ms ({by_})")
        del out

    # a step's six draws on the host clock (splits included), kernel
    # against the plain version on the card, in turns
    def six(kernel: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (shape, span) in enumerate(step):
            k = jrandom.fold_in(jrandom.PRNGKey(31), i)
            if kernel:
                jrandom.randint(k, shape, 0, span, device=cuda)
            else:
                hv = [jrandom._words(x) for x in jrandom.split(k)]
                jrandom._draw_plain(*hv, math.prod(shape), 0, span, 0, cuda,
                                    None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ops.reset_launches()
    six(True)
    rows["step_six_draws_launches"] = sum(ops.threefry_counts().values())
    assert rows["step_six_draws_launches"] == len(step), rows
    six(False)
    turns = {"kernel": [], "plain": []}
    for _ in range(20):
        for side in ("plain", "kernel", "kernel", "plain"):
            turns[side].append(six(side == "kernel"))
    rows["step_six_draws_host_ms"] = {
        side: statistics.median(v) for side, v in turns.items()}
    log(f"threefry: a cifar10_case2 step's six draws, host ms (median of "
        f"40): kernel {rows['step_six_draws_host_ms']['kernel']:.4f}, plain "
        f"{rows['step_six_draws_host_ms']['plain']:.4f}")
    rows["sass"] = sass = threefry_sass()
    for mode, ops_ in (sass or {"-": None}).items():
        log(f"threefry: SASS of mode {mode}: "
            f"{'not measured (no cuobjdump)' if ops_ is None else ops_}")
    return rows


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
    parser.add_argument("--launch-only", action="store_true",
                        help="build, then phase 11 (the launch layer) "
                             "alone, into chiprun_out/chip_smoke_launch.json")
    parser.add_argument("--lm-only", action="store_true",
                        help="build, then phase 12 (LM serving) alone, "
                             "into chiprun_out/chip_smoke_lm.json")
    parser.add_argument("--lm-train-only", action="store_true",
                        help="build, then phase 13 (LM training) alone, "
                             "into chiprun_out/chip_smoke_lm_train.json")
    parser.add_argument("--wide-only", action="store_true",
                        help="build, then phase 14 (the wide route) alone, "
                             "into chiprun_out/chip_smoke_wide.json")
    parser.add_argument("--threefry-only", action="store_true",
                        help="build, then phase 15 (the threefry kernel) "
                             "alone, into chiprun_out/chip_smoke_threefry"
                             ".json")
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}")                    # beside every number below
    report: dict = {"device": torch.cuda.get_device_name(0), "card": smi}
    secs = build.build_all()
    report["build_s"] = secs
    report["ptxas"] = dict(build.BUILD_LOG)
    log(f"build: CUDA kernels built in {secs:.1f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    ck = Checker(torch, np, P)
    if args.launch_only:
        launch, _ = phase_launch(ck, np)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_launch.json").write_text(
            json.dumps(launch, indent=1))
        return 0
    if args.lm_only:
        lm = phase_lm(ck)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_lm.json").write_text(json.dumps(lm, indent=1))
        return 0
    if args.lm_train_only:
        OUT_DIR.mkdir(exist_ok=True)
        lm = phase_lm_train(ck)
        (OUT_DIR / "chip_smoke_lm_train.json").write_text(
            json.dumps(lm, indent=1))
        return 0
    if args.threefry_only:
        res = phase_threefry(ck)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_threefry.json").write_text(json.dumps(
            dict(threefry=res, shapes=ck.rows), indent=1))
        finish(torch, smi, [threefry_entry(
            ck, res, res["step_six_draws_launches"],
            "a cifar10_case2 step's six draws (phase 15)", {})])
        return 0
    if args.wide_only:
        rows, wide, runs = phase_wide(ck, np)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_wide.json").write_text(json.dumps(
            dict(wide=wide, runs=runs, shapes=ck.rows), indent=1))
        kernels = kernel_entries(
            ck, list(WIDE_ENTRIES), rows, {},
            {k: runs[WIDE_RUN[k]][count_key(k)] for k in WIDE_ENTRIES},
            dict(WIDE_RUN),
            {k: {r: c[count_key(k)] for r, c in runs.items()}
             for k in WIDE_ENTRIES})
        for k in kernels:
            assert k["launches"] > 0, f"{k['name']} was not launched"
        finish(torch, smi, kernels)
        return 0
    rows = phase_kernels(ck, args.quick)
    rows.update(phase_kernels_gradient(ck, args.quick))
    rows.update(phase_kernels_protocols(ck, args.quick))
    proc_rows = phase_kernels_proc(ck, args.quick)
    phase_golden(np)
    phase_golden_protocols(np)
    # launches: each kernel's count from the full-width path that runs it
    # (coded_gradient and poly_eval are on no path of the protocol)
    counts = {k: 0 for k in TPU_KERNEL}
    path = {k: None for k in TPU_KERNEL}
    by_path = {k: {} for k in TPU_KERNEL}
    if not args.quick:
        fused_counts, summary, fused = phase_full(ck, np)
        report["full"] = summary
        report["faulty"] = phase_faulty(ck, np, fused)
        report["protocols"], report["protocol_launches"], float_res = \
            phase_protocols(ck, np, summary)
        report["serve"], report["serve_launches"] = phase_serve(
            ck, np, fused, float_res)
        report["proc"], proc_runs = phase_proc(ck, np, fused)
        report["sharded"], sharded_runs = phase_sharded(ck, np, fused)
        proc_runs.update(sharded_runs)
        fused.state = None                 # frees its device memory
        wide_rows, report["wide"], wide_runs = phase_wide(ck, np)
        rows.update(wide_rows)
        proc_runs.update(wide_runs)
        report["launch"], launch_counts = phase_launch(ck, np)
        proc_runs["launch_counter 2 jit steps cifar10_case2"] = \
            launch_counts
        report["lm"] = phase_lm(ck)
        report["lm_train"] = phase_lm_train(ck)
        report["threefry"] = phase_threefry(ck)
        for name in FUSED_PATH:
            counts[name] = fused_counts[name]
            path[name] = "fused cifar10_case2"
        # the coded-gradient kernels: Phase 3 of the proc workers
        for name, wl_ in (("coded_gradient_batched", FULL_WORKLOAD),
                          ("coded_gradient_matrix", "mnist10_like")):
            path[name] = f"{PROC_ENGINE} {wl_}"
            counts[name] = proc_runs[path[name]][name]
        for name in ("modmatmul", "modmatmul_batched"):
            by_path[name] = {
                "fused cifar10_case2": fused_counts[name],
                **{f"{p} cifar10_case2": c[name]
                   for p, c in report["protocol_launches"].items()},
                "serve cifar10_case2": report["serve_launches"].get(name, 0)}
        sec = report["lm_train"]["secure"]
        by_path["modmatmul"][f"train_secure {sec['arch']} "
                             f"L={sec['layers']} (thin)"] = \
            sec["launches"]["gemm:thin"]
        runs = {"fused": fused_counts, **report["protocol_launches"],
                "serve": report["serve_launches"]}
        for name, (gpath, run) in PATH_ENTRIES.items():
            key = f"gemm:{gpath}"
            counts[name] = runs[run].get(key, 0)
            assert counts[name] > 0, f"{gpath} was not launched on {run}"
            path[name] = f"{run} cifar10_case2"
            by_path[name] = {f"{r} cifar10_case2": c.get(key, 0)
                             for r, c in runs.items()}
        # the kernels past d = 58,004: launches on their wide fused run
        for name in WIDE_ENTRIES:
            run = WIDE_RUN[name]
            counts[name] = wide_runs[run][count_key(name)]
            assert counts[name] > 0, f"{name} was not launched on {run}"
            path[name] = run
            by_path[name] = {f"{r} cifar10_case2": c.get(count_key(name), 0)
                             for r, c in runs.items()}
        # the proc, sharded and wide paths: the caller's launches plus
        # every worker's or rank's
        for run, c in proc_runs.items():
            for name in TPU_KERNEL:
                by_path[name][run] = c.get(count_key(name), 0)
        # the threefry kernel: every draw of the fused fit (set-up's and
        # six a step), and by path every run's
        assert fused_counts["threefry"] >= 6 * summary["iters"], fused_counts
        tf_by_path = {f"{r} cifar10_case2": c.get("threefry", 0)
                      for r, c in runs.items()}
        tf_by_path.update({r: c.get("threefry", 0)
                           for r, c in proc_runs.items()})
    report["shapes"] = ck.rows

    kernels = kernel_entries(ck, list(TPU_KERNEL), rows, proc_rows, counts,
                             path, by_path)
    if not args.quick:
        kernels.append(threefry_entry(
            ck, report["threefry"], fused_counts["threefry"],
            "fused cifar10_case2", tf_by_path))
    report["kernels"] = kernels
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    finish(torch, smi, kernels)
    return 0


def kernel_entries(ck: Checker, names: list, rows: dict, proc_rows: dict,
                   counts: dict, path: dict, by_path: dict) -> list:
    """The kernels line's entries for `names`: launches on the path that
    runs each (and by path), the comparisons with its plain version, and
    its times and bound at its main-path shape."""
    kernels = []
    for name in names:
        r = rows.get(name, {})
        pr = proc_rows.get(name)
        # the row's shape is of the workload whose run the launches count
        if path[name] is not None:
            assert r.get("workload") == path[name].split()[-1], \
                (name, path[name], r.get("workload"), r.get("shape"))
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
    return kernels


def finish(torch, smi: str, kernels: list) -> None:
    """The last three lines: the kernels, the card, and the result."""
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
